"""Choose between the fast-sort tour and the GA-optimized tour.

Parity with compare_fast_sort_and_allhic (scripts/HapHiC_sort.py:645-724):
weighted longest-increasing-subsequence agreement between the two tours,
tried over every rotation of the fast-sort tour; the GA tour wins when
the group is highly fragmented (group_len / longest > 50) or when the
tours agree (LIS length ratio >= 0.9).

The signed order list is rotation-invariant (rotating the tour only
rotates the sequence), so it is built once and the rotation scan runs
in native/tour_lis.cpp — a Fenwick-tree max-weight-increasing-
subsequence per rotation, O(n log n) each with an early exit, instead
of the reference's O(n^2) Python DP per rotation (O(n^3) total; a
thousand-contig group would dwarf the batched GA it arbitrates).
The pure-Python DP below is the parity oracle and the fallback when
the native library cannot be built.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Tour = List[Tuple[str, str]]

_LIS_LIB = None
_LIS_LOADED = False


def _native_lis():
    global _LIS_LIB, _LIS_LOADED
    if _LIS_LOADED:
        return _LIS_LIB
    _LIS_LOADED = True
    import ctypes
    from haphic_tpu_torch.utils.nativelib import load_shared
    lib = load_shared('libtourlis.so', ['tour_lis.cpp'])
    if lib is not None:
        lib.lis_any_rotation_exceeds.restype = ctypes.c_int
        lib.lis_any_rotation_exceeds.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    _LIS_LIB = lib
    return lib


def _find_lis(compare: Sequence[int], weight: Dict[int, int],
              forward: bool) -> int:
    """Max-weight increasing subsequence over the signed order list
    (parity: scripts/HapHiC_sort.py:648-674)."""
    if forward:
        orders = [o for o in compare if o > 0]
    else:
        orders = [o for o in compare if o < 0]
    if not orders:
        return 0
    dp = [0] * len(orders)
    best = 0
    for i in range(len(orders)):
        dp[i] = weight[orders[i]]
        for j in range(i):
            if orders[i] > orders[j] and dp[i] < dp[j] + weight[orders[i]]:
                dp[i] = dp[j] + weight[orders[i]]
        if dp[i] >= dp[best]:
            best = i
    return dp[best]


def _any_rotation_agrees_py(signed: List[int], weights: List[int],
                            group_len: int) -> bool:
    """The reference rotation loop, verbatim semantics (fallback +
    parity oracle for the native kernel)."""
    n = len(signed)
    compare = list(signed)
    wts = list(weights)
    # the reference tries len-1 rotations (zero for a 1-contig tour,
    # which therefore keeps the fast-sort tour)
    for _ in range(n - 1):
        weight = dict(zip(compare, wts))
        max_sum = max(_find_lis(compare, weight, True),
                      _find_lis(compare, weight, False))
        if max_sum / group_len >= 0.9:
            return True
        compare = compare[1:] + [compare[0]]
        wts = wts[1:] + [wts[0]]
    return False


def _any_rotation_agrees(signed: List[int], weights: List[int],
                         group_len: int) -> bool:
    lib = _native_lis()
    if lib is None:
        return _any_rotation_agrees_py(signed, weights, group_len)
    import numpy as np
    import ctypes
    v = np.asarray(signed, dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    return bool(lib.lis_any_rotation_exceeds(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(v), float(group_len), 0.9))


def choose_fast_sort(fast_tour: Tour, ga_tour: Tour,
                     lengths: Dict[str, int]) -> bool:
    """True → keep the fast-sort tour; False → keep the GA tour."""
    ctgs = [c for c, _ in fast_tour]
    oris = [o for c, o in fast_tour]
    ctg_lens = [lengths[c] for c in ctgs]
    group_len = sum(ctg_lens)
    if group_len / max(ctg_lens) > 50:
        return False

    ga_index = {c: i for i, (c, _) in enumerate(ga_tour)}
    ga_ori = {c: o for c, o in ga_tour}
    signed = []
    for i, c in enumerate(ctgs):
        j = ga_index[c]
        signed.append((j + 1) if oris[i] == ga_ori[c] else -(j + 1))
    return not _any_rotation_agrees(signed, ctg_lens, group_len)

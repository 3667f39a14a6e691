"""Seeded links for the sparse engine's ELL build (``coo_to_ell`` and
the ``ell_build`` kernel), shared by the CPU tests against the JAX
package and the card tests against the host's numpy. No JAX here."""

import numpy as np

from haphic_tpu_torch.kernels.ell_build import SMEM_MAX

CASES = ('exact', 'capped', 'duplicates', 'zero_and_empty', 'star', 'large')
KS = (8, 16, 128, 256)


def links(case: str, K: int, seed: int = 0):
    """(i, j, w, n) of one case at K:

    exact           a band of K // 2 links each side: every column's width
                    (its self-loop included) at most K;
    capped          about 2K random links a column with weights 1 or 2,
                    so that the top K breaks ties to the lower row;
    duplicates      a mixed triangle: a background of random links, and
                    runs of 2, 5, 9 and 20 links between one pair, in
                    both orientations, of non-integer weights over 16
                    decades (the run sums' order shows);
    zero_and_empty  columns whose links weigh 0.0 or -0.0, columns whose
                    sum is 0 or below (a link of -1.0; 2K links of -1.0,
                    whose kept sum is below 0 too), and columns with no
                    link (a self-loop alone);
    star            a hub linked to every other column: its column is
                    wider than the kernel's shared memory holds;
    large           about 300,000 links over 40,000 columns: a random
                    background of weights over 16 decades, 40 hub columns
                    of 1,500 links each (past every K; half of them of
                    weights 1 or 2, so that the top K breaks ties), and
                    runs of 129 to 600 links between one pair, in both
                    orientations, of weights over 16 decades: numpy's
                    pairwise sums and tie rules at long runs and wide
                    columns, every column within shared memory.
    """
    rng = np.random.default_rng([seed, K, CASES.index(case)])
    if case == 'exact':
        n, h = 3 * K + 7, (K - 1) // 2
        c = np.repeat(np.arange(n), h)
        d = np.tile(np.arange(1, h + 1), n)
        keep = c + d < n
        i, j = c[keep], (c + d)[keep]
        w = rng.random(i.size) * 100
    elif case == 'capped':
        n = 4 * K + 9
        E = n * K
        i, j = rng.integers(0, n, E), rng.integers(0, n, E)
        w = rng.integers(1, 3, E).astype(np.float64)
    elif case == 'duplicates':
        n = 2 * K + 11
        E = n * 3
        i, j = rng.integers(0, n, E), rng.integers(0, n, E)
        w = rng.random(E) * 10
        parts_i, parts_j, parts_w = [i], [j], [w]
        for run in (2, 5, 9, 20):
            a, b = rng.choice(n, 2, replace=False)
            flip = rng.random(run) < 0.5
            parts_i.append(np.where(flip, b, a))
            parts_j.append(np.where(flip, a, b))
            parts_w.append(rng.random(run) * 10.0 ** rng.uniform(-8, 8, run))
        order = rng.permutation(sum(p.size for p in parts_i))
        i, j, w = (np.concatenate(p)[order]
                   for p in (parts_i, parts_j, parts_w))
    elif case == 'zero_and_empty':
        n = 6 * K + 5
        others = np.arange(5, n)
        rng.shuffle(others)
        empty = others[:K]                       # no link: a self-loop
        rest = others[K:]
        i = rng.choice(rest, n * 2)
        j = rng.choice(rest, n * 2)
        w = rng.random(i.size)
        # column 0: links of 0.0 and -0.0; column 1: one link of -1.0
        # (sum 0); column 2: 2K links of -1.0 (sum and kept sum below 0)
        z = rng.choice(rest, K + 3, replace=False)
        neg = rng.choice(rest, 2 * K, replace=False)
        i = np.concatenate([i, np.zeros(z.size, np.int64), [1],
                            np.full(neg.size, 2)])
        j = np.concatenate([j, z, [z[0]], neg])
        w = np.concatenate([w, np.where(np.arange(z.size) % 2, 0.0, -0.0),
                            [-1.0], -np.ones(neg.size)])
    elif case == 'star':
        n = SMEM_MAX + 2 * K + 3
        i = np.zeros(n - 1, np.int64)
        j = np.arange(1, n)
        w = rng.integers(1, 4, n - 1).astype(np.float64)
    elif case == 'large':
        n, E, hubs, per = 40_000, 240_000, 40, 1_500
        i, j = rng.integers(0, n, E), rng.integers(0, n, E)
        w = rng.random(E) * 10.0 ** rng.uniform(-8, 8, E)
        hub = rng.choice(n, hubs, replace=False)
        hi = np.repeat(hub, per)
        hj = rng.integers(0, n, hubs * per)
        hw = np.where(np.repeat(np.arange(hubs) % 2, per) == 0,
                      rng.integers(1, 3, hubs * per).astype(np.float64),
                      rng.random(hubs * per) * 10.0 ** rng.uniform(
                          -8, 8, hubs * per))
        parts_i, parts_j, parts_w = [i, hi], [j, hj], [w, hw]
        for run in (129, 130, 200, 257, 300, 600):
            a, b = rng.choice(n, 2, replace=False)
            flip = rng.random(run) < 0.5
            parts_i.append(np.where(flip, b, a))
            parts_j.append(np.where(flip, a, b))
            parts_w.append(rng.random(run) * 10.0 ** rng.uniform(-8, 8, run))
        order = rng.permutation(sum(p.size for p in parts_i))
        i, j, w = (np.concatenate(p)[order]
                   for p in (parts_i, parts_j, parts_w))
    else:
        raise ValueError(case)
    return (np.asarray(i, np.int64), np.asarray(j, np.int64),
            np.asarray(w, np.float64), int(n))

"""The dense MCL column pass (haphic_tpu_torch.kernels.mcl_column)
against the JAX package's, on the CPU, where the wrapper runs its plain
version.

One pass (iteration 0 from the pre-expanded matrix, and one later
iteration from JAX's own expansion of JAX's first iterate) is held to
JAX's _mcl_batched within rtol 1e-5 / atol 1e-8 with equal nonzero sets:
both run f32, but exp/log and the column sums round in another order.
_prune is held to JAX's on planted columns (ties, zero columns, entries
at the threshold, a column whose max lies below it), the convergence
statistic to the f64 formula on JAX's iterates within 1e-7 and its
decision to JAX's _allclose. Within the port, _mcl_batched computes bit
for bit the composition it computed before the pass had a kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haphic_tpu.cluster import mcl as jmcl

from haphic_tpu_torch.cluster import mcl as tmcl
from haphic_tpu_torch.kernels import mcl_column as kmc

from .kit import kernelkit as kit

torch.set_num_threads(1)

PRUNING = 1e-4
RTOL, ATOL = 1e-5, 1e-8


def _pre(n, seed):
    """A column-normalized, squared (n, n) f32 block matrix: blocks of
    24 with random links, sparse noise between them, self loops."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for lo in range(0, n, 24):
        s = slice(lo, min(n, lo + 24))
        k = s.stop - s.start
        w = rng.integers(5, 60, (k, k)) * (rng.random((k, k)) < 0.6)
        a[s, s] += np.triu(w, 1) + np.triu(w, 1).T
    i, j = rng.integers(0, n, (2, n))
    a[i, j] += 2
    a[j, i] += 2
    a += np.eye(n, dtype=np.float32)
    a /= a.sum(axis=0, keepdims=True)
    return (a @ a).astype(np.float32)


def _infl(B):
    return np.linspace(1.2, 3.0, B, dtype=np.float32)


def _jax(pre, infl, max_iter):
    m, _, _ = jmcl._mcl_batched(jnp.asarray(pre), jnp.asarray(infl),
                                expansion=2, max_iter=max_iter,
                                pruning=PRUNING, precision='highest')
    return np.array(m)


def _assert_pass(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got != 0, want != 0)


@pytest.mark.parametrize('n', [96, 130])
@pytest.mark.parametrize('B', [1, 3])
def test_iteration0_matches_jax(B, n):
    pre, infl = _pre(n, B * n), _infl(B)
    want = _jax(pre, infl, 1)
    e = torch.as_tensor(pre)[None].expand(B, n, n)
    got, stat = kmc.mcl_column_plain(e, torch.as_tensor(infl), PRUNING)
    assert stat is None
    _assert_pass(got.numpy(), want)


@pytest.mark.parametrize('n', [96, 130])
@pytest.mark.parametrize('B', [1, 3])
def test_later_iteration_matches_jax(B, n):
    """One pass after the first, on JAX's expansion of JAX's first
    iterate, against JAX's max_iter=2."""
    pre, infl = _pre(n, B * n + 1), _infl(B)
    m0 = _jax(pre, infl, 1)
    want = _jax(pre, infl, 2)
    e = np.array(jmcl._matpower(jnp.asarray(m0), 2, 'highest'))
    got, stat = kmc.mcl_column_plain(torch.as_tensor(e),
                                     torch.as_tensor(infl), PRUNING,
                                     old=torch.as_tensor(m0))
    _assert_pass(got.numpy(), want)
    assert stat.shape == (B,)


def _planted(case):
    """(n, 6) columns, each normalized; pruning 0.25."""
    m = np.zeros((12, 6), np.float32)
    if case == 'ties':
        m[[3, 7, 11], 0] = 1 / 3               # above pruning: all kept
        m[[2, 5], 1] = 0.5
        m[[1, 4, 6, 8, 9], 2] = 0.2            # below it: the first kept
    elif case == 'zero-column':
        m[:, 1] = 0.0
        m[[0, 5], 0] = [0.75, 0.25]
        m[[4, 9], 2] = [0.5, 0.5]
    elif case == 'at-threshold':
        m[[0, 1, 2, 3], 0] = 0.25              # exactly pruning: kept
        m[[5, 6], 1] = [0.75, 0.25]
        m[[7, 8, 9, 10], 2] = [0.25, 0.25, 0.375, 0.125]
    elif case == 'max-below':
        m[:10, 0] = 0.1                        # max < pruning
        m[[1, 2, 3, 4, 5], 1] = [0.2, 0.2, 0.15, 0.25, 0.2]
        m[6:12, 2] = [0.125, 0.125, 0.125, 0.125, 0.25, 0.25]
    m[:, 3:] = m[:, :3][::-1]
    return m


@pytest.mark.parametrize('case', ['ties', 'zero-column', 'at-threshold',
                                  'max-below'])
def test_prune_matches_jax_on_planted_columns(case):
    m = _planted(case)
    want = np.asarray(jmcl._prune(jnp.asarray(m), 0.25))
    got = kmc._prune(torch.as_tensor(m), 0.25).numpy()
    assert np.array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the first argmax row of every column is kept
    first = np.argmax(m, axis=0)
    nonzero = m.any(axis=0)
    assert (got[first, np.arange(6)][nonzero] > 0).all()
    assert (got[:, ~nonzero] == 0).all()


@pytest.mark.parametrize('iters', [(2, 3), (40, 41)],
                         ids=['moving', 'converged'])
def test_statistic_matches_f64_and_allclose(iters):
    """The statistic of JAX's iterates at two successive iteration
    counts, against the f64 formula; its decision against _allclose."""
    pre, infl = _pre(96, 5), np.asarray([1.6, 2.4, 3.0], np.float32)
    old, new = (_jax(pre, infl, k) for k in iters)
    stat = kmc._stat(torch.as_tensor(new), torch.as_tensor(old)).numpy()
    want = (np.abs(new.astype(np.float64) - old) - 1e-5 * np.abs(
        old.astype(np.float64))).max(axis=(1, 2))
    np.testing.assert_allclose(stat, want, rtol=0, atol=1e-7)
    decision = np.asarray(jmcl._allclose(jnp.asarray(new),
                                         jnp.asarray(old)))
    assert np.array_equal(stat <= 1e-8, decision)
    if iters[0] == 40:
        assert decision.any()
    else:
        assert not decision.any()


def test_wrapper_on_cpu_takes_the_plain_version():
    pre, infl = _pre(64, 9), torch.as_tensor(_infl(3))
    e = torch.as_tensor(pre)[None].expand(3, 64, 64)
    old = torch.rand(3, 64, 64, generator=torch.Generator().manual_seed(0))
    n0 = kmc.mcl_column.launches
    got = kmc.mcl_column(e, infl, PRUNING, old=old)
    want = kmc.mcl_column_plain(e, infl, PRUNING, old=old)
    assert kmc.mcl_column.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kmc.mcl_column(e, infl, PRUNING)[1] is None


@pytest.mark.parametrize('bad', ['f64', 'not-square', 'infl-length',
                                 'old-shape', 'column-major',
                                 'empty-batch'])
def test_wrapper_rejects_bad_input(bad):
    e = torch.rand(2, 16, 16)
    infl = torch.tensor([1.5, 2.0])
    old = torch.rand(2, 16, 16)
    if bad == 'f64':
        e = e.double()
    elif bad == 'not-square':
        e = e[:, :, :12]
    elif bad == 'infl-length':
        infl = infl[:1]
    elif bad == 'old-shape':
        old = old[:1]
    elif bad == 'empty-batch':
        e, infl, old = e[:0], infl[:0], old[:0]
    else:
        e = e.transpose(1, 2)
    with pytest.raises(ValueError):
        kmc.mcl_column(e, infl, PRUNING, old=old)


# the parent's composition, written out: the column pass before it had a
# kernel (cluster/mcl.py's _inflate, _prune, _converged, _mcl_batched)

def _colnorm_before(m):
    s = m.sum(dim=-2, keepdim=True)
    return m * torch.where(s > 0, 1.0 / s, torch.zeros_like(s))


def _prune_before(m, pruning):
    keep = m >= pruning
    keep.scatter_(-2, torch.argmax(m, dim=-2, keepdim=True), True)
    return _colnorm_before(torch.where(keep, m, torch.zeros_like(m)))


def _inflate_before(m, infl):
    pos = m > 0
    p = torch.where(pos, torch.exp(infl * torch.log(
        torch.where(pos, m, torch.ones_like(m)))), torch.zeros_like(m))
    return _colnorm_before(p)


def _mcl_batched_before(pre, inflations, expansion, max_iter, pruning):
    B, n = inflations.shape[0], pre.shape[-1]
    infl = inflations[:, None, None]
    m = _prune_before(_inflate_before(pre[None].expand(B, n, n), infl),
                      pruning)
    conv_at = torch.full((B,), max_iter, dtype=torch.int32)
    converged = torch.zeros((B,), dtype=torch.bool)
    active = torch.arange(B)
    it = 1
    while it < max_iter and active.numel():
        whole = active.numel() == B
        cur = m if whole else m[active]
        new = _prune_before(_inflate_before(
            tmcl._matpower(cur, expansion), infl[active]), pruning)
        if whole:
            m = new
        else:
            m[active] = new
        if it >= 2:
            d = (new - cur).abs() - 1e-5 * cur.abs()
            conv = d.amax(dim=(-2, -1)) <= 1e-8
            conv_at[active[conv]] = it + 1
            converged[active[conv]] = True
            active = active[~conv]
        it += 1
    return m, conv_at, converged


@pytest.mark.parametrize('expansion', [2, 3])
def test_mcl_batched_computes_what_it_computed_before(expansion):
    """On the CPU, _mcl_batched is bit-equal to the parent's composition,
    on a batch whose inflations freeze at different iterations."""
    pre = torch.as_tensor(_pre(120, 4))
    infl = torch.tensor([1.3, 2.0, 3.5, 5.0])
    got = tmcl._mcl_batched(pre, infl, expansion, 200, PRUNING)
    want = _mcl_batched_before(pre, infl, expansion, 200, PRUNING)
    assert len(set(want[1].tolist())) > 1          # frozen at different its
    assert bool(want[2].all())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the kernel's plan (kmc.plan): a function of n alone

SWITCHES = [512, 1024, 2048, 4096, 8192, 16384, 25600, kmc.N_MAX]


def _slabs(pl, n):
    """The (first row, rows) of each CTA's slab, as the kernel computes
    them: rank k starts at k * rows and holds at most rows of the n."""
    return [(k * pl.rows, max(0, min(pl.rows, n - k * pl.rows)))
            for k in range(pl.cluster)]


def test_plan_slabs_cover_every_row_once_for_every_n():
    """For every n from 1 to N_MAX the slabs, in rank order, tile the
    rows 0 .. n - 1: each starts where the one before it ended."""
    for n in range(1, kmc.N_MAX + 1):
        pl = kmc.plan(n)
        end = 0
        for lo, rows in _slabs(pl, n):
            assert lo == end or rows == 0, (n, pl)
            end = lo + rows if rows else end
        assert end == n, (n, pl)


@pytest.mark.parametrize('switch', SWITCHES)
def test_plan_rows_covered_once_near_switches(switch):
    """Near each switch, every row of every slab is held by exactly one
    thread of exactly one CTA: thread row group g of G = 256 / width
    takes the slab's rows g, g + G, ... (the kernel's kmax)."""
    for n in range(max(1, switch - 40), min(kmc.N_MAX, switch + 40) + 1):
        pl = kmc.plan(n)
        G = kmc.THREADS // pl.width
        count = np.zeros(n, np.int64)
        for lo, rows in _slabs(pl, n):
            for g in range(G):
                kmax = (rows - g + G - 1) // G if rows > g else 0
                count[lo + g + G * np.arange(kmax)] += 1
        assert (count == 1).all(), (n, pl)


def test_plan_shared_memory_widths_and_clusters():
    """Every n's slab and head fit a CTA's 232,448 bytes; widths are 8,
    16 or 32 columns (32-byte sectors), clusters 1 to 16 CTAs; slabs up
    to n = 16,384 leave three CTAs an SM, up to 25,600 two."""
    for n in range(1, kmc.N_MAX + 1):
        pl = kmc.plan(n)
        assert pl.smem == kmc.HEAD + pl.rows * pl.width * 4
        assert pl.smem <= 232448
        assert pl.width in (8, 16, 32) and pl.cluster in (1, 2, 4, 8, 16)
        assert pl.rows == -(-n // pl.cluster)
        if n <= 16384:
            assert 3 * pl.smem <= 228 * 1024 - 3 * 1024
        elif n <= 25600:
            assert 2 * pl.smem <= 228 * 1024 - 2 * 1024


@pytest.mark.parametrize('n,want', [
    (1, (32, 1, 1)), (512, (32, 1, 512)), (513, (32, 2, 257)),
    (3000, (32, 8, 375)), (8000, (32, 16, 500)), (8193, (16, 16, 513)),
    (12000, (16, 16, 750)), (19999, (16, 16, 1250)), (25601, (8, 16, 1601)),
    (70000, (8, 16, 4375))])
def test_plan_is_a_function_of_n(n, want):
    """The same plan at every call and in any order of calls, from n
    alone (its one parameter), pinned at the switches."""
    import inspect
    assert list(inspect.signature(kmc.plan).parameters) == ['n']
    first = kmc.plan(n)
    kmc.plan(max(1, n - 1))
    kmc.plan(min(kmc.N_MAX, n + 1))
    assert kmc.plan(n) == first
    assert (first.width, first.cluster, first.rows) == want


@pytest.mark.parametrize('n', [0, -1, kmc.N_MAX + 1, 10 ** 6])
def test_plan_raises_past_its_capacity(n):
    with pytest.raises(ValueError, match='N_MAX = 70000'):
        kmc.plan(n)


def test_stat_parts_one_a_cta():
    for n in (1, 8000, 19999, 70000):
        pl = kmc.plan(n)
        assert kmc.stat_parts(n, pl) == -(-n // pl.width) * pl.cluster


def test_compare_counts_a_one_sided_nan():
    """kit.mcl_column_compare: a NaN on both sides agrees (a column sum
    whose reciprocal overflows gives NaN in both versions), a NaN on one
    side only is outside the tolerance."""
    want = torch.tensor([[[0.5, float('nan')], [0.5, 0.0]]])
    q = want.clone()
    same = kit.mcl_column_compare(want.clone(), want, q, PRUNING)
    assert same['outside_tol'] == 0 and same['max_abs_err'] == 0.0
    got = want.clone()
    got[0, 0, 0] = float('nan')
    one = kit.mcl_column_compare(got, want, q, PRUNING)
    assert one['outside_tol'] == 1 and one['max_abs_err'] == float('inf')

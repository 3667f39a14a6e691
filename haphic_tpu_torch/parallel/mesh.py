"""Multi-card sharding on torch.distributed: port of
haphic_tpu/parallel/mesh.py.

Execution model: one process per card. A run is launched with torchrun
(``python -m torch.distributed.run --nproc_per_node N -m
haphic_tpu_torch pipeline ... --use_mesh on``); every process runs the
same command, and ``init_distributed`` joins them into one process
group from torchrun's environment. Where the JAX package annotates
placements and lets XLA insert the collectives, the port shards by hand:
contiguous slices by rank (``shard_range``) and the named collectives
below. The four sharded places, as in the JAX package:

  * ingest: each rank consumes its stride of the alignment stream and
    the partial link tensors are exchanged once (parallel/ingest.py);
  * the dense MCL sweep: each rank runs its slice of the inflations,
    with no traffic until the partitions are gathered
    (``mcl_sweep_sharded_partitions``);
  * the sparse MCL step: each rank computes its block of columns
    against the all-gathered iterate (cluster/sparse_mcl.py);
  * the GA: each rank evolves its slice of the groups of every batch
    (order/optimize.py).

Every rank ends each sharded place with the whole result, so every rank
writes the whole tree.

Backends: NCCL when every rank of the node has a card of its own, gloo
when ranks share a card (NCCL refuses two ranks on one device) and for
every CPU run. Gloo's collectives are documented for CUDA tensors only
for broadcast and all_reduce, so they stage through host tensors; the
compute stays on the card.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from haphic_tpu_torch.cluster.mcl import (MCLResult, _colnorm, run_mcl,
                                          run_mcl_partitions)
from haphic_tpu_torch.runtime import resolve_device

logger = logging.getLogger(__name__)

# set when init_distributed created the default group (and so may
# destroy it)
_owned = False


def pick_backend(device, world_size: int) -> str:
    """'nccl' when ``device`` is a card and this node's ranks
    (LOCAL_WORLD_SIZE, else the whole world) have one card each; 'gloo'
    otherwise."""
    if torch.device(device).type != 'cuda':
        return 'gloo'
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
    return 'nccl' if local <= torch.cuda.device_count() else 'gloo'


def init_distributed(device='cuda', init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> int:
    """Join the default process group and return the world size.

    Without ``init_method`` the group comes from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the
    card, see runtime.resolve_device); the backend is pick_backend's.
    With neither an ``init_method``
    nor WORLD_SIZE this is a single-process run: nothing is joined and
    1 is returned. A second call returns the existing group's size. A
    misconfigured environment raises; there is no single-process
    fallback."""
    global _owned
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and 'WORLD_SIZE' not in os.environ:
        return 1
    rank = int(os.environ['RANK']) if rank is None else rank
    world_size = (int(os.environ['WORLD_SIZE']) if world_size is None
                  else world_size)
    dev = resolve_device(device)
    backend = pick_backend(dev, world_size)
    if dev.index is not None:
        # NCCL binds the rank's communicator to the current device
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            rank=rank, world_size=world_size)
    _owned = True
    logger.info('Joined a %d-process %s group as rank %d on %s',
                world_size, backend, rank, dev)
    return world_size


def shutdown_distributed() -> None:
    """Destroy the default group if init_distributed created it."""
    global _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass
class Mesh:
    """The ranks the hot stages shard over: one process per card.
    ``group`` None is the default group. ``stats`` adds up the seconds,
    bytes and calls of this mesh's collectives."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    backend: str
    stats: dict = field(default_factory=lambda: {
        'collective_s': 0.0, 'collective_bytes': 0, 'collectives': 0})


def make_mesh(device='cuda') -> Mesh:
    """The mesh of the default group, with this rank's device."""
    return Mesh(group=None, rank=dist.get_rank(),
                world=dist.get_world_size(), device=resolve_device(device),
                backend=dist.get_backend())


def _share(n: int, rank: int, world: int) -> Tuple[int, int]:
    base, extra = divmod(n, world)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


def shard_range(n: int, mesh: Mesh) -> Tuple[int, int]:
    """[start, stop) of this rank's contiguous share of n items: near
    equal, the first n % world ranks one more; a rank may get none."""
    return _share(n, mesh.rank, mesh.world)


class _Timed:
    """Adds one collective's seconds and bytes to ``mesh.stats``; on a
    card the clock waits for the work queued before and by it."""

    def __init__(self, mesh: Mesh, nbytes: int):
        self.mesh, self.nbytes = mesh, nbytes

    def _sync(self):
        if self.mesh.device.type == 'cuda':
            torch.cuda.synchronize(self.mesh.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._sync()
        st = self.mesh.stats
        st['collective_s'] += time.perf_counter() - self.t0
        st['collective_bytes'] += self.nbytes
        st['collectives'] += 1


def _wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: ``x`` for NCCL, a host copy for
    gloo."""
    x = x.contiguous()
    return x if mesh.backend == 'nccl' else x.cpu()


def all_gather_cols(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(B, M, K) on every rank -> (B, world * M, K) on ``x``'s device,
    rank r's block at columns [r * M, (r + 1) * M)."""
    src = _wire(mesh, x)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    with _Timed(mesh, src.numel() * src.element_size() * mesh.world):
        dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=1).to(x.device)


def all_gather_shares(mesh: Mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, shard of n, ...) on every rank, each rank's share of n along
    axis 1 as shard_range gives it -> (B, n, ...) in rank order."""
    m = -(-n // mesh.world)
    pad = [0, 0] * (x.dim() - 2) + [0, m - x.shape[1]]
    full = all_gather_cols(mesh, torch.nn.functional.pad(x, pad))
    return torch.cat([full[:, r * m:r * m + (e - s)] for r, (s, e) in
                      enumerate(_share(n, r, mesh.world)
                                for r in range(mesh.world))], dim=1)


def _all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    buf = _wire(mesh, x.clone())
    with _Timed(mesh, buf.numel() * buf.element_size()):
        dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(x.device)


def all_reduce_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Element-wise max of ``x`` over the ranks (``x`` unchanged)."""
    return _all_reduce(mesh, x, dist.ReduceOp.MAX)


def all_reduce_min(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Element-wise min of ``x`` over the ranks (``x`` unchanged)."""
    return _all_reduce(mesh, x, dist.ReduceOp.MIN)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Element-wise sum of ``x`` over the ranks (``x`` unchanged)."""
    return _all_reduce(mesh, x, dist.ReduceOp.SUM)


def all_gather_object(mesh: Mesh, obj) -> List:
    """Every rank's ``obj`` (picklable), in rank order. Its bytes in
    ``mesh.stats`` are this rank's pickle."""
    out = [None] * mesh.world
    with _Timed(mesh, len(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))):
        dist.all_gather_object(out, obj, group=mesh.group)
    return out


def mcl_sweep_sharded_partitions(mesh: Mesh,
                                 adjacency: Optional[np.ndarray],
                                 inflations: Sequence[float],
                                 expansion: int = 2, max_iter: int = 200,
                                 pruning: float = 1e-4, coo=None):
    """Inflation-sharded dense sweep returning per-inflation cluster
    partitions: each rank runs cluster.mcl.run_mcl_partitions on its
    contiguous slice of the inflations (no traffic), interprets its own
    matrices, and the partitions, iteration counts and converged flags
    are gathered to every rank in inflation order. ``adjacency`` and
    ``coo`` as run_mcl_partitions takes them. Returns (partitions,
    n_iters, converged)."""
    infl = [float(f) for f in inflations]
    s, e = shard_range(len(infl), mesh)
    mine = ([], np.zeros(0, np.int32), np.zeros(0, bool))
    if e > s:
        mine = run_mcl_partitions(adjacency, infl[s:e], expansion=expansion,
                                  max_iter=max_iter, pruning=pruning,
                                  coo=coo, device=mesh.device)
    got = all_gather_object(mesh, mine)
    parts = [p for g in got for p in g[0]]
    iters = np.concatenate([np.asarray(g[1], np.int32) for g in got])
    conv = np.concatenate([np.asarray(g[2], bool) for g in got])
    logger.info('Inflation-sharded MCL sweep over %d ranks: inflations '
                '[%d, %d) here', mesh.world, s, e,
                extra={'metrics': {'mcl_shard': [s, e],
                                   'mcl_world': mesh.world}})
    return parts, iters, conv


def mcl_sweep_sharded(mesh: Mesh, adjacency: np.ndarray,
                      inflations: Sequence[float], expansion: int = 2,
                      max_iter: int = 200, pruning: float = 1e-4):
    """Inflation-sharded dense sweep returning the full result matrices
    on every rank (cluster.mcl.MCLResult): each rank runs
    cluster.mcl.run_mcl on its slice of the inflations and the
    matrices are gathered. Heavy on the wire: the pipeline takes
    mcl_sweep_sharded_partitions, which gathers only partitions."""
    infl = [float(f) for f in inflations]
    s, e = shard_range(len(infl), mesh)
    m = adjacency.shape[0]
    mine = (np.zeros((0, m, m), np.float32), np.zeros(0, np.int32),
            np.zeros(0, bool))
    if e > s:
        r = run_mcl(adjacency, infl[s:e], expansion=expansion,
                    max_iter=max_iter, pruning=pruning, device=mesh.device)
        mine = (r.matrices, r.n_iters, r.converged)
    got = all_gather_object(mesh, mine)
    return MCLResult(matrices=np.concatenate([g[0] for g in got]),
                     n_iters=np.concatenate([g[1] for g in got]),
                     converged=np.concatenate([g[2] for g in got]))


def mcl_sharded_matrix(mesh: Mesh, adjacency: np.ndarray, inflation: float,
                       expansion: int = 2, max_iter: int = 200,
                       pruning: float = 1e-4) -> np.ndarray:
    """Single-inflation dense MCL with the (m, m) matrix row-sharded over
    the ranks, for a matrix too large for one card's product: each rank
    holds its rows (shard_range), all-gathers the matrix for the
    expansion product (its rows times the whole), and the column sums of
    the normalizations, the column argmax the pruning keeps and the
    convergence statistic are all-reduced. Semantics of
    cluster.mcl._mcl_batched at one inflation; the column sums add
    per-rank partial sums, so the matrix agrees with the meshless one
    to f32 rounding, not bit for bit. Returns the final matrix on every
    rank."""
    m = adjacency.shape[0]
    r0, r1 = shard_range(m, mesh)
    dev = mesh.device
    a = _colnorm(torch.as_tensor(adjacency.astype(np.float32), device=dev))
    pre = a[r0:r1]                     # rows of a ** expansion
    for _ in range(expansion - 1):
        pre = torch.matmul(pre, a)
    rows = torch.arange(r0, r1, device=dev)[:, None]

    def gather(x):
        return all_gather_shares(mesh, x[None], m)[0]

    def colnorm(x):
        s = all_reduce_sum(mesh, x.sum(dim=0, keepdim=True))
        return x * torch.where(s > 0, 1.0 / s, torch.zeros_like(s))

    def inflate(x):
        pos = x > 0
        return colnorm(torch.where(pos, torch.exp(inflation * torch.log(
            torch.where(pos, x, torch.ones_like(x)))), torch.zeros_like(x)))

    def prune(x):
        # the first row holding each column's max, over all ranks
        mx = all_reduce_max(mesh, x.amax(dim=0, keepdim=True))
        first = torch.where(x == mx, rows, m).amin(dim=0, keepdim=True)
        first = all_reduce_min(mesh, first)
        keep = (x >= pruning) | (rows == first)
        return colnorm(torch.where(keep, x, torch.zeros_like(x)))

    cur = prune(inflate(pre))
    for it in range(1, max_iter):
        full = gather(cur)
        new = cur
        for _ in range(expansion - 1):
            new = torch.matmul(new, full)
        new = prune(inflate(new))
        if it >= 2:
            d = ((new - cur).abs() - 1e-5 * cur.abs()).amax()
            done = all_reduce_max(mesh, d.view(1)) <= 1e-8
        cur = new
        if it >= 2 and bool(done):
            break
    return gather(cur).cpu().numpy()


class _ShardedScores:
    """A GA batch's records whose ``score`` computes this rank's share of
    the population rows and gathers every row's score: the population
    stays whole on every rank (every rank draws the same numbers), so
    only the (G, P) scores cross the ranks."""

    def __init__(self, mesh: Mesh, rec):
        self.mesh, self.rec = mesh, rec

    def score(self, order, ori):
        P = order.shape[1]
        p0, p1 = shard_range(P, self.mesh)
        mine = self.rec.score(order[:, p0:p1].contiguous(),
                              ori[:, p0:p1].contiguous())
        return all_gather_shares(self.mesh, mine, P)


def evolve_sharded(mesh: Mesh, problem, npop: int, ngen: int,
                   mutprob: float = 0.2, seed: int = 42,
                   chunk: Optional[int] = None):
    """Population-parallel GA of one group: the full-scoring (mu +
    lambda) evolution (order.optimize._evolve_impl) from an identity
    population, each rank scoring its share of the rows and the scores
    gathered for a global top-P selection. Returns host arrays of the
    evolved population, best first: (order (P, k_pad), ori, scores)."""
    from haphic_tpu_torch.order import optimize as opt

    chunk = opt.CHUNK if chunk is None else chunk
    k_pad = opt._bucket(problem.k, 8)
    c_eff = opt._effective_chunk(problem.n_records, chunk)
    pa, pb, d, w, _ = opt._pad_records(problem, c_eff)
    lengths = np.zeros((1, k_pad), np.int64)
    lengths[0, :problem.k] = problem.lengths
    dev = mesh.device

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    rec = opt._Records(put(lengths), put(pa[None]), put(pb[None]),
                       put(d[None]), put(w[None]))
    order = put(np.broadcast_to(np.arange(k_pad, dtype=np.int32),
                                (1, npop, k_pad)))
    ori = torch.zeros_like(order)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    o, r, s = opt._evolve_impl(opt._Draws(gen, 1),
                               _ShardedScores(mesh, rec), order, ori,
                               mutprob, ngen)
    return o[0].cpu().numpy(), r[0].cpu().numpy(), s[0].cpu().numpy()

"""Row-sharded kernel operator over a ``torch.distributed`` device mesh.

PyTorch port of ``mlff_tpu.parallel.mesh``.  The reference parallelizes with
fork pools over column blocks of K during assembly (reference:
sgdml/train.py:1267-1295) and over training-point ranges of the matvec
(sgdml/predict.py:451-500).  The JAX package maps that onto a 1-D 'rows'
mesh and lets GSPMD insert the collectives; here one process per rank holds
its rows and the collectives are written out (``RowShard``):

  * the (N, M) caches and the query-side descriptors are row-sharded by
    training point (``shard_cache``); the permuted training side ``Xqt``,
    ``S``, ``P_idx``, ``sig`` and ``lam`` are replicated,
  * every matvec all-gathers the per-point cotangents w (N, D), or the
    square layout's wt (M, A*A) together with its training side,
  * length-n vectors are sharded by rows; PCG all-reduces its dot products,
    every Woodbury apply its (m,) partial B^T v, the Nystrom build its
    (m, m) Gram; rank 0 alone runs the build's host LAPACK and broadcasts
    each (m, m) factor,
  * column assembly gathers the column points' descriptors and Jacobians
    once and forms its own rows of K[:, idx] (``column_side``).

N must divide evenly over the ranks: ``RowShard.rows`` raises ValueError
otherwise, as the JAX package leaves padding to the caller.  With the gloo
backend a CUDA tensor is staged through host memory for each collective
(logged once): compute stays on the card, and the staging happens only
because the caller chose gloo; NCCL takes CUDA tensors as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace
from ..utils.log import get_logger

log = get_logger(__name__)

ROWS = "rows"

_STAGING_LOGGED = False


def make_mesh(world_size: int | None = None, device_type: str | None = None):
    """1-D ``DeviceMesh`` over the 'rows' axis: the first ``world_size``
    ranks of the default group (all of them by default).  ``device_type``
    defaults to cuda under NCCL and cpu under gloo."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    world = dist.get_world_size()
    n = world if world_size is None else int(world_size)
    if not 1 <= n <= world:
        raise ValueError(f"world_size {n} not in [1, {world}]")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(ROWS,))


_SHARDS: dict = {}


def row_shard(mesh) -> "RowShard":
    """The ``RowShard`` of a mesh (one per mesh object): its 'rows' axis for
    a 1-D mesh, the flattened mesh for a 2-D ('hosts', 'rows') one."""
    hit = _SHARDS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if mesh.ndim == 1:
        group = mesh.get_group()
    else:
        ranks = sorted(mesh.mesh.flatten().tolist())
        group = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                 else dist.new_group(ranks))
    sh = RowShard(group)
    _SHARDS[id(mesh)] = (mesh, sh)
    return sh


class RowShard:
    """This rank's place on the rows axis of a mesh, and the collectives of
    the sharded operator over its process group."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        # where tensors made for a collective live: NCCL takes CUDA only
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))
        self._index_cache: dict = {}

    def rows(self, N: int) -> slice:
        """This rank's slice of N rows; ValueError unless N divides evenly
        over the ranks (callers pad if needed)."""
        if N % self.world:
            raise ValueError(
                f"{N} rows do not divide evenly over {self.world} ranks; "
                "the row-sharded operator needs N divisible by the mesh "
                "size (callers pad if needed)")
        b = N // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    # -- collectives -------------------------------------------------------

    def _comm(self, fn, t: torch.Tensor):
        """``fn`` on the tensor as the backend takes it (a host copy for gloo
        and a CUDA tensor); the result comes back on t's device.  Counted
        in the counter ``mesh.collectives``, and while ``utils.trace``
        records, a span ``mesh.collective``: the host's time to issue it
        (nothing is synchronized, so recording leaves the schedule as it
        is; the device's time is in the profiler's records of the
        call)."""
        global _STAGING_LOGGED
        stage = self.backend == "gloo" and t.is_cuda
        if stage and not _STAGING_LOGGED:
            _STAGING_LOGGED = True
            log.info("gloo backend with CUDA tensors: every collective is "
                     "staged through host memory (the caller chose gloo)")
        src = t.detach().cpu() if stage else t.detach().contiguous()
        with trace.span("mesh.collective"):
            out = fn(src)
        trace.count("mesh.collectives")
        return out if not stage else out.to(t.device)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """All-gather of equal-shaped per-rank blocks, concatenated along
        ``dim`` in rank order (the list form, on every torch version)."""
        def fn(src):
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.group)
            return torch.cat(parts, dim=dim)
        return self._comm(fn, t)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """Sum (or ``op``) over the ranks, into a new tensor."""
        def fn(src):
            # a host copy is fresh; anything else may share t's storage
            buf = src if src.device != t.device else src.clone()
            dist.all_reduce(buf, op=op, group=self.group)
            return buf
        return self._comm(fn, t)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s t on every rank, into a new tensor (the others
        pass a tensor of its shape and dtype)."""
        def fn(buf):
            buf = buf if buf.device != t.device else buf.clone()
            dist.broadcast(buf, src=dist.get_global_rank(self.group, src),
                           group=self.group)
            return buf
        return self._comm(fn, t)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Global dot product of two row-sharded vectors."""
        return self.all_reduce(torch.dot(a, b))

    def any(self, flag: bool) -> bool:
        """Whether any rank's flag is set (a decision every rank shares)."""
        t = torch.tensor([1.0 if flag else 0.0], dtype=torch.float64,
                         device=self.device)
        return bool(self.all_reduce(t, op=dist.ReduceOp.MAX)[0] > 0)

    def layout(self, segs) -> "VecLayout":
        return VecLayout(self, segs)


class VecLayout:
    """The row layout of a sharded vector: segments of global lengths
    ``segs``, each split evenly over the ranks; a rank holds its part of
    every segment, concatenated.  Force vectors have one segment (n,); the
    energy-constrained system two, (n, N), so that each rank holds its own
    points' force and energy entries."""

    def __init__(self, shard: RowShard, segs):
        self.shard = shard
        self.segs = tuple(int(s) for s in segs)
        for s in self.segs:
            shard.rows(s)                      # raises unless even
        self.n = sum(self.segs)
        self.lsegs = tuple(s // shard.world for s in self.segs)
        self.n_local = sum(self.lsegs)
        self.starts = tuple(np.cumsum((0,) + self.segs[:-1]).tolist())
        self.lstarts = tuple(np.cumsum((0,) + self.lsegs[:-1]).tolist())

    def local_index(self, rank: int | None = None) -> np.ndarray:
        """Global indices of a rank's local positions (this rank's by
        default)."""
        r = self.shard.rank if rank is None else rank
        return np.concatenate([np.arange(st + r * ls, st + (r + 1) * ls)
                               for st, ls in zip(self.starts, self.lsegs)])

    def _index_dev(self, device) -> torch.Tensor:
        key = (self.segs, str(device))
        cache = self.shard._index_cache
        if key not in cache:
            cache[key] = torch.as_tensor(self.local_index(), device=device)
        return cache[key]

    def scatter(self, v) -> torch.Tensor:
        """This rank's part of a global vector (no communication)."""
        v = torch.as_tensor(v)
        return v[torch.as_tensor(self.local_index(), device=v.device)]

    def gather(self, v_loc: torch.Tensor) -> torch.Tensor:
        """The global vector (leading axis) on every rank."""
        parts = self.shard.gather(v_loc)
        perm = np.concatenate([self.local_index(r)
                               for r in range(self.shard.world)])
        out = torch.empty_like(parts)
        out[torch.as_tensor(perm, device=parts.device)] = parts
        return out

    def owner_pos(self, g: torch.Tensor):
        """(owner rank, local position) of global indices ``g``."""
        owner = torch.zeros_like(g)
        pos = torch.zeros_like(g)
        for st, sg, ls, lst in zip(self.starts, self.segs, self.lsegs,
                                   self.lstarts):
            inside = (g >= st) & (g < st + sg)
            off = g - st
            r = torch.div(off, ls, rounding_mode="floor")
            owner = torch.where(inside, r, owner)
            pos = torch.where(inside, lst + off - r * ls, pos)
        return owner, pos

    def _mine(self, g: torch.Tensor):
        owner, pos = self.owner_pos(g)
        mine = owner == self.shard.rank
        return mine, torch.where(mine, pos, torch.zeros_like(pos))

    def take(self, t_loc: torch.Tensor, g) -> torch.Tensor:
        """Rows ``t[g]`` of the global array at global indices ``g``, on every
        rank: the owners contribute their rows, the others zeros, summed
        (exact: one nonzero term per entry)."""
        g = torch.as_tensor(g, device=t_loc.device).reshape(-1)
        mine, pos = self._mine(g)
        rows = t_loc[pos]
        mask = mine.reshape((-1,) + (1,) * (rows.dim() - 1))
        return self.shard.all_reduce(torch.where(mask, rows,
                                                 torch.zeros_like(rows)))

    def add_at(self, t_loc: torch.Tensor, g, val) -> torch.Tensor:
        """``t[g[j], j] += val`` (2-D t, one column per index) or
        ``t[g] += val`` (1-D t) on the owners' rows, in place."""
        g = torch.as_tensor(g, device=t_loc.device).reshape(-1)
        mine, pos = self._mine(g)
        add = torch.where(mine, torch.as_tensor(val, dtype=t_loc.dtype,
                                                device=t_loc.device),
                          torch.zeros((), dtype=t_loc.dtype,
                                      device=t_loc.device))
        if t_loc.dim() == 1:
            t_loc.index_put_((pos,), add, accumulate=True)
        else:
            cols = torch.arange(g.shape[0], device=t_loc.device)
            t_loc.index_put_((pos, cols), add, accumulate=True)
        return t_loc

    def set_at(self, t_loc: torch.Tensor, g, val) -> torch.Tensor:
        """``t[g] = val`` on the owner's row, in place (1-D t, one index)."""
        g = torch.as_tensor(g, device=t_loc.device).reshape(-1)
        mine, pos = self._mine(g)
        t_loc[pos] = torch.where(mine, val, t_loc[pos])
        return t_loc

    def argmax(self, v_loc: torch.Tensor):
        """(global index (1,), value (1,)) of the largest entry of the
        global vector, ties to the lowest global index (``torch.argmax``'s
        first occurrence); nothing is read back to the host."""
        i = torch.argmax(v_loc)
        gi = self._index_dev(v_loc.device)[i]
        pair = torch.stack([v_loc[i], gi.to(v_loc.dtype)])
        both = self.shard.gather(pair[None]).reshape(-1, 2)
        best = torch.max(both[:, 0])
        cand = torch.where(both[:, 0] == best, both[:, 1],
                           torch.full_like(both[:, 1], float("inf")))
        return torch.min(cand).to(torch.int64).reshape(1), best.reshape(1)


# ---------------------------------------------------------------------------
# Placing caches, vectors and preconditioners
# ---------------------------------------------------------------------------

# KernelCache fields with a leading training-point axis; the square
# assembly projections (Usq, Zsq, C1sq) are indexed [column point, row
# point] and shard on their row-point axis, the one a rank's rows read
_CACHE_ROW_FIELDS = ("X", "Jc", "Xq", "A_exp", "A_exp1", "Xsq", "Gsq")
_CACHE_ROW1_FIELDS = ("Usq", "Zsq", "C1sq")


def shard_cache(cache, mesh):
    """This rank's rows of a built ``KernelCache`` (packed, on-the-fly with
    ``A_exp is None``, with or without the square fields); the replicated
    fields stay whole.  ValueError unless N divides evenly."""
    sh = row_shard(mesh)
    if cache.shard is not None:
        raise ValueError("cache is already row-sharded")
    r = sh.rows(cache.n_train)
    upd = {}
    for name in _CACHE_ROW_FIELDS:
        t = getattr(cache, name)
        if t is not None:
            upd[name] = t[r].clone()
    for name in _CACHE_ROW1_FIELDS:
        t = getattr(cache, name)
        if t is not None:
            upd[name] = t[:, r].clone()
    return dataclasses.replace(cache, shard=sh, **upd)


def unshard_cache(cache):
    """The whole cache on every rank, from a row-sharded one (the dense
    small-n diagnostics run replicated on it)."""
    if cache.shard is None:
        return cache
    sh = cache.shard
    upd = {}
    for name in _CACHE_ROW_FIELDS:
        t = getattr(cache, name)
        if t is not None:
            upd[name] = sh.gather(t)
    for name in _CACHE_ROW1_FIELDS:
        t = getattr(cache, name)
        if t is not None:
            upd[name] = sh.gather(t, dim=1)
    return dataclasses.replace(cache, shard=None, **upd)


def column_side(cache):
    """The column side of an assembly on a row-sharded cache: a cache whose
    descriptors, Jacobians and square fields cover every training point
    (all-gathered once; (N, D)-sized, P times smaller than the replicated
    Xqt), indexed by global point.  An unsharded cache is its own column
    side."""
    if cache.shard is None:
        return cache
    sh = cache.shard
    upd = {name: sh.gather(getattr(cache, name))
           for name in ("X", "Jc", "Xsq", "Gsq")
           if getattr(cache, name) is not None}
    return dataclasses.replace(cache, shard=None, **upd)


def shard_square_cache(sq, mesh):
    """This rank's rows of a ``SquareCache``: every field with a leading
    training-point axis, the permuted training side (Gst, Xst: M = N P rows,
    point-major) included."""
    sh = row_shard(mesh)
    if sq.shard is not None:
        raise ValueError("square cache is already row-sharded")
    N = sq.Gs.shape[0]
    P = sq.perms.shape[0]
    r = sh.rows(N)
    rm = slice(r.start * P, r.stop * P)
    return dataclasses.replace(
        sq, Gs=sq.Gs[r].clone(), Xs=sq.Xs[r].clone(),
        Gst=sq.Gst[rm].clone(), Xst=sq.Xst[rm].clone(),
        A_exp=sq.A_exp[r].clone(), A_exp1=sq.A_exp1[r].clone(), shard=sh)


def shard_vector(v, mesh, segs=None) -> torch.Tensor:
    """This rank's part of a global vector (one segment of its whole length
    by default; ``segs=(n, N)`` for the energy-constrained system)."""
    v = torch.as_tensor(v)
    segs = (v.shape[0],) if segs is None else segs
    return row_shard(mesh).layout(segs).scatter(v)


def gather_vector(v_loc: torch.Tensor, mesh, segs=None) -> torch.Tensor:
    """The global vector from every rank's part (inverse of
    ``shard_vector``)."""
    sh = row_shard(mesh)
    segs = (v_loc.shape[0] * sh.world,) if segs is None else segs
    return sh.layout(segs).gather(v_loc)


def shard_preconditioner(precon, mesh, segs=None):
    """Place a Woodbury-family preconditioner on the mesh.

    The big (n, m) factor is row-sharded like the kernel operator (split,
    column-blocked, df64 and Ozaki forms; each rank's part of the Ozaki
    digits padded again to 256 rows); the fused T (k, n) is sharded by
    columns; the (m, m) inner factor, the Ozaki scales and lam are
    replicated.  The counterpart of the JAX package's function: the solve
    never needs it, because every builder run on a row-sharded cache
    returns a sharded operator, which this returns as it is, as it does
    callables of other kinds.
    ``segs``: the vector layout (default one segment of the factor's row
    count, which for the Ozaki digits includes their zero rows: pass the
    vectors' ``segs`` there)."""
    from ..solvers import preconditioners as pc

    if getattr(precon, "layout", None) is not None:
        return precon
    sh = row_shard(mesh)

    def lay(n):
        return sh.layout((n,) if segs is None else segs)

    def rows_of(t, lo):
        idx = torch.as_tensor(lo.local_index(), device=t.device)
        return t[idx].contiguous()

    if isinstance(precon, pc.WoodburySplitPreconditioner):
        lo = lay(precon.B.shape[0])
        return dataclasses.replace(precon, B=rows_of(precon.B, lo), layout=lo)
    if isinstance(precon, pc.WoodburyPreconditioner):
        lo = lay(precon.T.shape[1])
        return dataclasses.replace(precon, T=rows_of(precon.T.T, lo).T,
                                   layout=lo)
    if isinstance(precon, pc.WoodburyColBlockPreconditioner):
        lo = lay(precon.Bs[0].shape[0])
        return dataclasses.replace(
            precon, Bs=tuple(rows_of(B, lo) for B in precon.Bs), layout=lo)
    if isinstance(precon, pc.DF64WoodburyPreconditioner):
        lo = lay(precon.Bh.shape[0])
        return dataclasses.replace(
            precon, Bh=rows_of(precon.Bh, lo), Bl=rows_of(precon.Bl, lo),
            Bm=None if precon.Bm is None else rows_of(precon.Bm, lo),
            layout=lo)
    if isinstance(precon, pc.OzakiApplyPreconditioner):
        # the digits carry zero rows up to a multiple of 256: the vector
        # length comes from ``segs`` unless there are none
        lo = lay(precon.B_dig[0].shape[0])
        n_pad = -(-lo.n_local // 256) * 256
        dig = tuple(torch.nn.functional.pad(
            rows_of(d, lo), (0, 0, 0, n_pad - lo.n_local))
            for d in precon.B_dig)
        return dataclasses.replace(precon, B_dig=dig, layout=lo)
    return precon

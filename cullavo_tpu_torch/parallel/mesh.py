"""Several processes over ``torch.distributed`` (counterpart of
``cullavo_tpu/parallel/mesh.py``, whose ``jax.distributed`` and
``NamedSharding`` mesh it replaces): JAX's three axes, ``data``, ``fsdp``
and ``tensor``.

The grid.  ``MeshConfig`` resolves the axes over the process count as
JAX's does over its devices, and rank ``(i_d * F + i_f) * T + i_t`` sits
at ``(i_d, i_f, i_t)``, the order of ``make_mesh``'s ``reshape(data, fsdp,
tensor)``.  ``ParallelContext.create`` makes one process group per line of
the grid (``dist.new_group``): the fsdp group (same ``i_d, i_t``), the
tensor group (same ``i_d, i_f``), the data group (same ``i_f, i_t``) and
the batch group (same ``i_t``: the D * F ranks that hold different rows).

The batch.  Every rank reads the same global batch (the same ``SEED`` and
record order) and takes part ``i_d * F + i_f`` of D * F
(``ParallelContext.rows``, ``np.array_split``'s split; JAX's
``P(("data", "fsdp"))``): ranks that differ only in ``i_t`` take the same
rows.  The training steps turn the parts into one global step: a loss's
denominators are summed over the batch group, the X-Decoder's losses take
their part's share (``BatchPart``), and gradients are summed over the
ranks that hold different rows, never over ranks that hold the same ones.

The layout.  ``shard_spec`` is JAX's ``_fsdp_spec`` rule for rule: at most
one sharded dim a leaf, the tensor axis on the last dim of a leaf with two
dims or more when it divides, else the fsdp axis on the first dim that
divides (from dim 1 for a stacked leaf).  ``Layout`` holds one tree's
specs: ``shard`` / ``unshard`` move between whole leaves and this rank's
slices; ``gather`` turns a step's shards into whole leaves with a gradient
(``_GatherMany``: one all-gather of the shards' bytes per axis; its
backward one reduce-scatter a dtype over the fsdp group, or this rank's
slices over the tensor group, whose ranks already hold equal gradients),
or, for the stacked layer leaves, into ``Shard``s that gather one layer of
all of them at a time where the layer function indexes them; ``reduce`` sums each gradient shard over
the ranks that still hold other rows (the data group after an fsdp
reduce-scatter, the batch group for the rest) and makes the tensor ranks'
copies of the leaves they share equal; ``global_norm`` sums each leaf's
squares over the group that shards it, replicated leaves once.  On the
data axis alone every spec is None: ``gather`` is the identity and
``reduce`` the flat sum over the batch group, so the training steps take
a ``Layout`` on every grid.  A frozen
tree needs no ``Layout``: ``ParallelContext.shard_tree`` stores its
sharded leaves as ``Shard``s, which ``gather_tree`` gathers.  The
collectives are the backend's ``all_gather_into_tensor`` and
``reduce_scatter_tensor``: NCCL's, and Gloo's on host and on CUDA tensors
(several ranks on one card), which stages them through the host.

``initialize_distributed`` reads the launcher's contract
(``scripts/node_run.sh``: ``CULLAVO_COORDINATOR`` host:port,
``CULLAVO_NUM_PROCS``, ``CULLAVO_PROC_ID``).  The backend is NCCL where the
rank's device is CUDA and Gloo on the CPU; ``CULLAVO_DIST_BACKEND`` names
another (Gloo for several ranks on one card: NCCL takes one rank a
device).  A rank's device is ``cuda:(rank % device_count)``.  Collectives
time out after ``DIST_TIMEOUT_S``, so that a rank that hangs makes the
others fail.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths

__all__ = ["MeshConfig", "ParallelContext", "BatchPart", "Layout", "Shard", "parallel_context",
           "initialize_distributed", "process_index", "process_count", "gather_rows",
           "gather_tree", "all_reduce_tree", "shard_spec"]

DIST_TIMEOUT_S = 900    # a collective that waits longer raises


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1      # -1: absorb the remaining processes
    fsdp: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> tuple:
        d, f, t = self.data, self.fsdp, self.tensor
        known = (f if f > 0 else 1) * (t if t > 0 else 1)
        if d == -1:
            d = n_devices // known
        if d * f * t != n_devices:
            raise ValueError(f"mesh {d}x{f}x{t} != {n_devices} devices")
        return d, f, t


def shard_spec(shape, axes) -> Optional[tuple]:
    """JAX's ``_fsdp_spec`` for a leaf of ``shape`` on a grid whose fsdp and
    tensor axes have sizes ``axes = (F, T)``: ``(dim, "tensor")``, ``(dim,
    "fsdp")`` or None (replicated)."""
    fsdp, tensor = axes
    ndim = len(shape)
    if (fsdp == 1 and tensor == 1) or ndim == 0:
        return None
    if tensor > 1 and ndim >= 2 and shape[-1] % tensor == 0:
        return ndim - 1, "tensor"
    if fsdp > 1:
        for i in range(1 if ndim >= 2 else 0, ndim):   # never the stacked-layer axis
            if shape[i] % fsdp == 0:
                return i, "fsdp"
    return None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def grid_groups(d: int, f: int, t: int) -> dict:
    """Every process group of each axis of a ``d x f x t`` grid, as lists of
    ranks in ascending order (a rank's place in its list is its coordinate
    on the axis; on the batch axis, its part ``i_d * f + i_f``)."""
    rank = lambda i, j, k: (i * f + j) * t + k   # noqa: E731
    return {"fsdp": [[rank(i, j, k) for j in range(f)] for i in range(d) for k in range(t)],
            "tensor": [[rank(i, j, k) for k in range(t)] for i in range(d) for j in range(f)],
            "data": [[rank(i, j, k) for i in range(d)] for j in range(f) for k in range(t)],
            "batch": [[rank(i, j, k) for i in range(d) for j in range(f)] for k in range(t)]}


@dataclasses.dataclass
class ParallelContext:
    """This rank's place on the grid of ``fsdp`` x ``tensor`` x the rest
    (data) over the process group, the groups of its axes (``groups``: an
    axis absent from it spans every rank), and the collectives the steps
    and the pipelines use.  ``timings``: one ``(kind, step, ms or events)``
    entry per timed collective inside a step (``begin_step`` /
    ``end_step``), ``timed_ms`` sums them per step."""
    fsdp: int = 1
    tensor: int = 1
    groups: dict = dataclasses.field(default_factory=dict)
    timings: list = dataclasses.field(default_factory=list)
    steps: int = 0
    _timing: bool = False

    @classmethod
    def create(cls, fsdp: int = 1, tensor: int = 1) -> "ParallelContext":
        """The context of this rank, its axes' groups made: every rank calls
        ``dist.new_group`` for every group, in one order.  An axis of one
        rank needs no group, and one of every rank takes the default."""
        world, rank = process_count(), process_index()
        d = world // (fsdp * tensor)
        groups = {}
        for axis, lines in grid_groups(d, fsdp, tensor).items():
            if len(lines[0]) in (1, world):
                continue
            for ranks in lines:
                handle = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = handle
        return cls(fsdp, tensor, groups)

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def process_count(self) -> int:
        return process_count()

    @property
    def is_main(self) -> bool:
        return process_index() == 0

    @property
    def coords(self) -> tuple:
        """(i_d, i_f, i_t) of this rank."""
        r, f, t = process_index(), self.fsdp, self.tensor
        return r // (f * t), (r // t) % f, r % t

    def axis_size(self, axis: str) -> int:
        d = process_count() // (self.fsdp * self.tensor)
        return {"fsdp": self.fsdp, "tensor": self.tensor, "data": d, "batch": d * self.fsdp}[axis]

    def axis_index(self, axis: str) -> int:
        i_d, i_f, i_t = self.coords
        return {"fsdp": i_f, "tensor": i_t, "data": i_d, "batch": i_d * self.fsdp + i_f}[axis]

    def group(self, axis: str):
        """The axis's process group handle (None: the default group)."""
        return self.groups.get(axis)

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n``: part ``i_d * F + i_f`` of ``np.array_split``'s
        D * F contiguous parts (tensor ranks take the same rows)."""
        parts = self.axis_size("batch")
        sizes = [len(a) for a in np.array_split(np.arange(n), parts)]
        b = self.axis_index("batch")
        start = sum(sizes[:b])
        return slice(start, start + sizes[b])

    def barrier(self) -> None:
        dist.barrier()

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the batch group (the ranks that hold different
        rows), in place; returns it."""
        if self.axis_size("batch") > 1:
            dist.all_reduce(t, group=self.group("batch"))
        return t

    def allgather_objects(self, obj) -> list:
        """Every rank's ``obj`` (any picklable object), in rank order."""
        out = [None] * self.process_count
        dist.all_gather_object(out, obj)
        return out

    # -- timing ---------------------------------------------------------------
    def begin_step(self) -> None:
        self._timing = True

    def end_step(self) -> None:
        self._timing = False
        self.steps += 1

    @contextlib.contextmanager
    def timed(self, cuda: bool, kind: str = "reduce"):
        """Time the block inside a step: CUDA events on the current stream
        when ``cuda`` (read later by ``timed_ms``, so nothing synchronises
        here), else the host clock."""
        if not self._timing:
            yield
        elif cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.timings.append((kind, self.steps, (start, end)))
        else:
            t = time.perf_counter()
            yield
            self.timings.append((kind, self.steps, (time.perf_counter() - t) * 1e3))

    def timed_ms(self, kind: str = "reduce") -> list:
        """The ms of the ``kind`` collectives of each step so far ("reduce":
        the gradient reductions, "gather": the gathers and their backward
        reduce-scatters); synchronises the card."""
        if any(isinstance(x, tuple) for _, _, x in self.timings):
            torch.cuda.synchronize()
        per = [0.0] * self.steps
        for k, step, x in self.timings:
            if k == kind and step < self.steps:
                per[step] += x[0].elapsed_time(x[1]) if isinstance(x, tuple) else x
        return per

    # -- the collectives of the layout -------------------------------------------
    def all_gather_many(self, xs: list, specs: list) -> list:
        """The whole leaf of each shard of ``xs`` (``specs``: (dim, axis)):
        the slices of the axis's group concatenated along dim in its order,
        with one all-gather per axis of the shards' bytes (each with its dim
        moved first) in one buffer."""
        out = [None] * len(xs)
        for axis in ("fsdp", "tensor"):
            idx = [i for i, s in enumerate(specs) if s is not None and s[1] == axis]
            n = self.axis_size(axis)
            if not idx or n == 1:
                for i in idx:
                    out[i] = xs[i]
                continue
            moved = [xs[i].movedim(specs[i][0], 0).contiguous() for i in idx]
            flat = torch.cat([m.reshape(-1).view(torch.uint8) for m in moved])
            buf = flat.new_empty((n * flat.numel(),))
            with self.timed(flat.is_cuda, "gather"):
                dist.all_gather_into_tensor(buf, flat, group=self.group(axis))
            buf, off = buf.view(n, -1), 0
            for i, m in zip(idx, moved):
                nb = m.numel() * m.element_size()
                part = buf[:, off:off + nb].contiguous().view(m.dtype)
                out[i] = part.reshape((n * m.shape[0],) + tuple(m.shape[1:])).movedim(
                    0, specs[i][0]).contiguous()
                off += nb
        return out

    def reduce_scatter_many(self, gs: list, dims: list) -> list:
        """``reduce_scatter`` over the fsdp axis of each whole gradient of
        ``gs`` along its dim, with one collective per dtype."""
        n = self.axis_size("fsdp")
        if n == 1:
            return list(gs)
        out = [None] * len(gs)
        for dtype in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            moved = [gs[i].movedim(dims[i], 0).contiguous() for i in idx]
            flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1).reshape(-1)
            part = flat.new_empty((flat.numel() // n,))
            with self.timed(flat.is_cuda, "gather"):
                dist.reduce_scatter_tensor(part, flat, group=self.group("fsdp"))
            off = 0
            for i, m in zip(idx, moved):
                k = m.numel() // n
                out[i] = part[off:off + k].reshape((m.shape[0] // n,) + tuple(m.shape[1:])) \
                    .movedim(0, dims[i]).contiguous()
                off += k
        return out

    def own(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's slice of the whole ``x`` along ``dim`` on ``axis`` (a
        copy: the whole can be freed)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        s = x.shape[dim] // n
        return x.narrow(dim, self.axis_index(axis) * s, s).clone(
            memory_format=torch.contiguous_format)

    def shard_tree(self, tree):
        """Whole leaves -> ``Shard``s of this rank's slices where JAX's rule
        shards them (``Shard`` leaves stay)."""
        def keep(t):
            if isinstance(t, Shard) or not isinstance(t, torch.Tensor):
                return t
            spec = shard_spec(tuple(t.shape), (self.fsdp, self.tensor))
            return t if spec is None else Shard(self.own(t, *spec), spec, self)
        return tree_map(keep, tree)

    def part(self, total: int) -> "BatchPart":
        """This rank's ``rows(total)`` of a global batch, as a loss sees them."""
        sl = self.rows(total)
        return BatchPart(self, sl.start, sl.stop - sl.start, total)


@dataclasses.dataclass(frozen=True)
class BatchPart:
    """This rank's rows ``offset:offset + n`` of a global batch of ``total``,
    as the losses of a data-parallel step take them.  A loss then returns
    this rank's share, and the shares of the batch group's parts sum to the
    one-process loss of the global batch: a per-row loss divides this
    rank's sum by the global denominator (``sum``); a batch-coupled loss (a
    contrastive term) is computed on rows gathered with gradient
    (``gather``), and its share is its value over the number of parts
    (``share``).  Random draws are made for the global batch and this
    rank's rows taken (``rows``), so the generator runs as in one process."""
    ctx: ParallelContext
    offset: int
    n: int
    total: int

    def rows(self, per_row: int = 1) -> tuple:
        """(start, stop, total) of this rank's part of a draw with
        ``per_row`` rows an image."""
        return self.offset * per_row, (self.offset + self.n) * per_row, self.total * per_row

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a denominator: no gradient) summed over the parts."""
        return self.ctx.sum_rows(x.detach().clone())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [n, ...] -> the global batch [total, ...]."""
        if self.ctx.axis_size("batch") == 1:
            return x
        return gather_rows(x, self.offset, self.total, self.ctx.group("batch"))

    def share(self, loss: torch.Tensor) -> torch.Tensor:
        """A loss every part computes whole -> this part's share of it."""
        return loss / self.ctx.axis_size("batch")


def parallel_context(cfg: dict) -> Optional[ParallelContext]:
    """The grid of ``MESH_DATA`` / ``MESH_FSDP`` / ``MESH_TENSOR`` over the
    process group (resolved as JAX resolves its mesh: one process with an
    axis above 1 raises its ``ValueError``); None without a process group."""
    mesh = MeshConfig(data=int(cfg.get("MESH_DATA", -1)), fsdp=int(cfg.get("MESH_FSDP", 1)),
                      tensor=int(cfg.get("MESH_TENSOR", 1)))
    _, f, t = mesh.resolve(process_count())
    return ParallelContext.create(f, t) if _initialized() else None


def initialize_distributed(coordinator: Optional[str], num_processes: Optional[int],
                           process_id: Optional[int], device=None) -> bool:
    """Join the process group of ``num_processes`` ranks at
    ``tcp://coordinator`` as rank ``process_id``; nothing for one process.
    ``device``: "cpu" takes Gloo, else the rank's CUDA device and NCCL (where
    there is a card).  Returns whether a group was joined."""
    if num_processes is None or num_processes <= 1:
        return False
    if not coordinator:
        raise ValueError("several processes need CULLAVO_COORDINATOR (host:port of rank 0's "
                         "rendezvous)")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"CULLAVO_PROC_ID={process_id} is not a rank of {num_processes}")
    cuda = (device is None or torch.device(device).type == "cuda") and torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    backend = os.environ.get("CULLAVO_DIST_BACKEND") or ("nccl" if cuda else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return True


class _GatherRows(torch.autograd.Function):
    """x [b, ...] -> [sum of b, ...]: every rank's rows in rank order, by an
    all-reduce of a zero-filled buffer of x's dtype holding this rank's rows
    (a sum with zeros is exact).  The backward sums the incoming gradient
    over the ranks and returns this rank's rows: each rank's gradient is
    the loss's over the number of parts, so for two ranks the sum of two
    halves is exact in any float type."""

    @staticmethod
    def forward(ctx, x, offset, total, group):
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[offset:offset + x.shape[0]] = x
        dist.all_reduce(buf, group=group)
        ctx.rows, ctx.group = (offset, x.shape[0]), group
        return buf

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        offset, n = ctx.rows
        return g[offset:offset + n], None, None, None


def gather_rows(x: torch.Tensor, offset: int, total: int, group=None) -> torch.Tensor:
    """The global batch [total, ...] of ``x``, this rank's rows from
    ``offset``, over ``group`` (None: every rank); differentiable where
    ``x`` takes a gradient.  When each rank computes the loss of the
    gathered batch divided by the number of parts, the ranks' summed
    gradients are the one-process gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, offset, total, group)
    buf = x.new_zeros((total,) + tuple(x.shape[1:]))
    buf[offset:offset + x.shape[0]] = x
    dist.all_reduce(buf, group=group)
    return buf


def all_reduce_tree(leaves: list, group=None) -> list:
    """Sum a list of tensors over ``group`` (None: every rank): one flat
    buffer per dtype, one all-reduce each; returns new tensors of the
    leaves' shapes."""
    return _flat_collective(leaves, lambda flat: dist.all_reduce(flat, group=group))


def _flat_collective(leaves: list, op) -> list:
    """``op`` (in place) on one flat buffer per dtype of ``leaves``; returns
    new tensors of the leaves' shapes."""
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        op(flat)
        for i, part in zip(idx, torch.split(flat, [leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return out


# ---------------------------------------------------------------------------
# the layout of a tree over the fsdp and tensor axes
# ---------------------------------------------------------------------------

class _GatherMany(torch.autograd.Function):
    """Shards -> their whole leaves (``ParallelContext.all_gather_many``).
    The backward: over the fsdp axis the ranks hold different rows, so
    their gradients of the wholes are summed and each keeps its slices (one
    reduce-scatter a dtype); over the tensor axis they hold the same rows
    and equal gradients, so each takes its slices."""

    @staticmethod
    def forward(ctx, par, specs, *xs):
        ctx.par, ctx.specs = par, specs
        wholes = par.all_gather_many(list(xs), specs)
        ctx.like = [(w.shape, w.dtype, w.device) for w in wholes]
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        par, specs = ctx.par, ctx.specs
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        out = [None] * len(grads)
        fsdp = [i for i, (_, a) in enumerate(specs) if a == "fsdp"]
        for i, g in zip(fsdp, par.reduce_scatter_many([grads[i] for i in fsdp],
                                                      [specs[i][0] for i in fsdp])):
            out[i] = g
        for i, (d, a) in enumerate(specs):
            if a == "tensor":
                out[i] = par.own(grads[i], d, a)
        return (None, None, *out)


def gather_many(xs: list, specs: list, par: ParallelContext) -> list:
    """The whole leaves of the shards ``xs`` (``specs``: (dim, axis) or None
    each), one all-gather per axis; differentiable where a shard takes a
    gradient."""
    out = list(xs)
    for grad in (True, False):
        idx = [i for i, (x, s) in enumerate(zip(xs, specs))
               if s is not None and (x.requires_grad and torch.is_grad_enabled()) == grad]
        if not idx:
            continue
        sub, sub_specs = [xs[i] for i in idx], [specs[i] for i in idx]
        wholes = (_GatherMany.apply(par, sub_specs, *sub) if grad
                  else par.all_gather_many(sub, sub_specs))
        for i, w in zip(idx, wholes):
            out[i] = w
    return out


class _LayerBucket:
    """The ``Shard``s of one stacked tree (a model's layer leaves, or its
    adapters).  Indexing one of them at layer ``li`` gathers layer ``li`` of
    every member in one collective per axis (with a gradient where they
    take one); each member then takes its own whole, so a rank holds one
    layer's leaves at a time."""

    def __init__(self):
        self.members, self.ready = [], {}

    def take(self, slot: int, li: int) -> torch.Tensor:
        if (li, slot) not in self.ready:
            ms = self.members
            wholes = gather_many([m.local[li] for m in ms],
                                 [(m.spec[0] - 1, m.spec[1]) for m in ms], ms[0].par)
            self.ready.update({(li, k): w for k, w in enumerate(wholes)})
        return self.ready.pop((li, slot))


class Shard:
    """A leaf of which this rank holds the slice ``local`` along ``spec`` =
    (dim, axis); ``shape`` is the whole leaf's, ``dtype`` the one its
    gathers are cast to.  The frozen base of a sharded step is a tree with
    ``Shard`` leaves (``ParallelContext.shard_tree``), which ``gather_tree``
    gathers.  A stacked layer leaf ``[L, ...]`` (never sharded along L) in a
    ``_LayerBucket`` gathers one layer: ``shard[li]``; it stands where
    ``llama_forward`` slices a layer of its stacked leaves, so that a rank
    holds one whole layer at a time, and the recomputation of a
    checkpointed layer gathers it again."""

    def __init__(self, local: torch.Tensor, spec: tuple, par: ParallelContext, dtype=None,
                 bucket=None, slot=0):
        self.local, self.spec, self.par = local, spec, par
        self.dtype = dtype or local.dtype
        self.bucket, self.slot = bucket, slot
        shape = list(local.shape)
        shape[spec[0]] *= par.axis_size(spec[1])
        self.shape = torch.Size(shape)
        self.device = local.device

    def dim(self) -> int:
        return len(self.shape)

    def to(self, dtype) -> "Shard":
        return Shard(self.local, self.spec, self.par, dtype, self.bucket, self.slot)

    def __getitem__(self, li: int) -> torch.Tensor:
        whole = self.bucket.take(self.slot, li)
        return whole if whole.dtype == self.dtype else whole.to(self.dtype)


def _stacked(path: tuple, stacked: tuple) -> bool:
    return any(path[:len(p)] == p for p in stacked)


def _gather_leaves(leaves: list, specs: list, paths: list, stacked: tuple,
                   par: ParallelContext) -> list:
    """``leaves`` (shards) -> whole leaves by one ``gather_many``; the sharded
    ones under a path prefix of ``stacked`` become ``Shard``s, one
    ``_LayerBucket`` a prefix."""
    out = list(leaves)
    for prefix in stacked:
        bucket = _LayerBucket()
        for i, (s, p) in enumerate(zip(specs, paths)):
            if s is not None and _stacked(p, (prefix,)):
                out[i] = Shard(leaves[i], s, par, bucket=bucket, slot=len(bucket.members))
                bucket.members.append(out[i])
    rest = [i for i, (s, p) in enumerate(zip(specs, paths))
            if s is not None and not _stacked(p, stacked)]
    for i, w in zip(rest, gather_many([leaves[i] for i in rest], [specs[i] for i in rest],
                                      par)):
        out[i] = w
    return out


def gather_tree(tree, stacked: tuple = ()):
    """A tree with ``Shard`` leaves (a frozen base) -> whole leaves, except
    the shards under a path prefix of ``stacked``, which become ``Shard``s
    gathered a layer at a time."""
    leaves = tree_leaves(tree)
    shards = [x for x in leaves if isinstance(x, Shard)]
    if not shards:
        return tree
    it = iter(_gather_leaves([x.local if isinstance(x, Shard) else x for x in leaves],
                             [x.spec if isinstance(x, Shard) else None for x in leaves],
                             tree_paths(tree), stacked, shards[0].par))
    return tree_map(lambda _: next(it), tree)


class Layout:
    """Where each leaf of one tree lives on the grid: ``specs`` (JAX's rule,
    from the whole leaves' shapes; tensors or ``meta`` tensors) and
    ``paths``, in ``tree_leaves`` order.  Trees handed to the methods have
    the structure of the tree it was made from."""

    def __init__(self, par: ParallelContext, whole):
        self.par = par
        self.paths = tree_paths(whole)
        self.specs = [shard_spec(tuple(t.shape), (par.fsdp, par.tensor))
                      if isinstance(t, torch.Tensor) else None for t in tree_leaves(whole)]

    def _map(self, fn, tree):
        """``fn(leaf, spec, path)`` over ``tree``'s leaves."""
        it = iter(zip(tree_leaves(tree), self.specs, self.paths))
        return tree_map(lambda _: fn(*next(it)), tree)

    def shard(self, tree):
        """Whole leaves -> this rank's slices (copies)."""
        return self._map(lambda t, s, _: t if s is None else self.par.own(t, *s), tree)

    def unshard(self, tree, device=None):
        """This rank's slices -> whole leaves (every rank takes part), each
        moved to ``device`` as it is gathered where one is given."""
        def whole(t, s, _):
            w = t if s is None else self.par.all_gather_many([t], [s])[0]
            return w if device is None else w.to(device)
        with torch.no_grad():
            return self._map(whole, tree)

    def gather(self, tree, stacked: tuple = ()):
        """A step's shards -> whole leaves with a gradient (one collective an
        axis); the sharded leaves under a path prefix of ``stacked`` become
        ``Shard``s gathered a layer at a time."""
        it = iter(_gather_leaves(tree_leaves(tree), self.specs, self.paths, stacked, self.par))
        return tree_map(lambda _: next(it), tree)

    def reduce(self, grads):
        """This rank's gradient shards (after ``gather``'s backward) -> the
        global step's: the fsdp-sharded leaves summed over the data group,
        the others over the batch group; then the leaves the tensor ranks
        share (replicated and fsdp-sharded) taken from the tensor group's
        first rank, so that no copy drifts where a kernel is not
        deterministic."""
        par, leaves = self.par, tree_leaves(grads)
        out = list(leaves)
        fsdp = [i for i, s in enumerate(self.specs) if s is not None and s[1] == "fsdp"]
        rest = [i for i, s in enumerate(self.specs) if s is None or s[1] == "tensor"]
        with par.timed(bool(leaves) and leaves[0].is_cuda):
            for idx, axis in ((fsdp, "data"), (rest, "batch")):
                if idx and par.axis_size(axis) > 1:
                    for i, t in zip(idx, all_reduce_tree([out[i] for i in idx],
                                                         par.group(axis))):
                        out[i] = t
            shared = [i for i, s in enumerate(self.specs) if s is None or s[1] == "fsdp"]
            if shared and par.tensor > 1:
                root = process_index() - par.axis_index("tensor")
                group = par.group("tensor")
                for i, t in zip(shared, _flat_collective(
                        [out[i] for i in shared],
                        lambda flat: dist.broadcast(flat, root, group=group))):
                    out[i] = t
        it = iter(out)
        return tree_map(lambda _: next(it), grads)

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of the global gradient of which
        ``grads`` holds this rank's shards: each sharded leaf's squares summed
        over the group that shards it, a replicated leaf's counted once."""
        par, leaves = self.par, tree_leaves(grads)
        sums = {k: torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                for k in ("rep", "fsdp", "tensor")}
        for g, s in zip(leaves, self.specs):
            k = "rep" if s is None else s[1]
            sums[k] = sums[k] + (g.float() * g.float()).sum()
        for axis in ("fsdp", "tensor"):
            if par.axis_size(axis) > 1:
                dist.all_reduce(sums[axis], group=par.group(axis))
        return torch.sqrt(sums["rep"] + sums["fsdp"] + sums["tensor"])

    def unshard_opt(self, opt_state, device=None):
        """The optimizer's state (``optimizer.py``'s dicts: ``mu`` / ``nu`` /
        ``acc_grads`` like the tree, counts replicated, ``inner`` nested) with
        whole leaves."""
        return {k: (self.unshard_opt(v, device) if k == "inner"
                    else self.unshard(v, device) if k in ("mu", "nu", "acc_grads") else v)
                for k, v in opt_state.items()}

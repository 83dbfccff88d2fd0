"""Several processes over ``torch.distributed`` (counterpart of
``cullavo_tpu/parallel/mesh.py``, whose ``jax.distributed`` and
``NamedSharding`` mesh it replaces): the data axis only.

Every rank reads the same global batch (the same ``SEED`` and record
order) and takes its rows (``ParallelContext.rows``, ``np.array_split``'s
split).  The training steps turn the ranks' parts into one global step: the
Q-LoRA loss divides each rank's weighted NLL sum by the global weight sum
(``all_reduce``), the X-Decoder joint step's losses take their rank's
share of the global batch (``BatchPart``: per-image losses over global
denominators, the contrastive terms over features gathered with gradient by
``gather_rows``, random points drawn for the global batch and sliced), and
the gradient trees are summed in flat buffers (``all_reduce_tree``).
Two ranks then take the step one process takes on the whole batch, as
JAX's SPMD step equals its single-device step.  The collectives are
``all_reduce`` (sum), ``barrier`` and ``all_gather_object``.

``MeshConfig`` resolves the axes over the process count as JAX's does over
its devices; ``MESH_FSDP`` or ``MESH_TENSOR`` above 1 raises
``NotImplementedError`` (the sharded NF4 base needs per-layer gathers of its
words in front of K6 / K7: ROADMAP.md queue 1 item 3, its second half).

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

__all__ = ["MeshConfig", "ParallelContext", "BatchPart", "parallel_context",
           "initialize_distributed", "process_index", "process_count", "gather_rows",
           "all_reduce_tree"]

NEXT_SLICE = ("the next slice of ROADMAP.md queue 1 item 3: the fsdp and tensor axes, with "
              "the NF4 base's per-layer gathers; the port runs the data axis (MESH_DATA)")
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


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


@dataclasses.dataclass
class ParallelContext:
    """The process group's data axis (every rank): this rank's rows of a
    global batch, and the collectives the steps and the pipelines use.
    ``timings``: one entry per ``timed`` block (the steps time their
    gradient all-reduce)."""
    timings: list = dataclasses.field(default_factory=list)

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def process_count(self) -> int:
        return process_count()

    @property
    def is_main(self) -> bool:
        return process_index() == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` (``np.array_split``'s contiguous split)."""
        sizes = [len(a) for a in np.array_split(np.arange(n), self.process_count)]
        start = sum(sizes[:self.process_index])
        return slice(start, start + sizes[self.process_index])

    def barrier(self) -> None:
        dist.barrier()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t)
        return t

    def allgather_objects(self, obj) -> list:
        """Every rank's ``obj`` (any picklable object), in rank order."""
        out = [None] * self.process_count
        dist.all_gather_object(out, obj)
        return out

    @contextlib.contextmanager
    def timed(self, cuda: bool):
        """Time the block: CUDA events on the current stream when ``cuda``
        (read later by ``timed_ms``, so nothing synchronises here), else the
        host clock."""
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.timings.append((start, end))
        else:
            t = time.perf_counter()
            yield
            self.timings.append((time.perf_counter() - t) * 1e3)

    def timed_ms(self) -> list:
        """The ms of every ``timed`` block so far (synchronises the card)."""
        if any(isinstance(x, tuple) for x in self.timings):
            torch.cuda.synchronize()
        return [x[0].elapsed_time(x[1]) if isinstance(x, tuple) else x for x in self.timings]

    def part(self, total: int) -> "BatchPart":
        """This rank's ``rows(total)`` of a global batch, as a loss sees them."""
        sl = self.rows(total)
        return BatchPart(self, sl.start, sl.stop - sl.start, total)


@dataclasses.dataclass(frozen=True)
class BatchPart:
    """This rank's rows ``offset:offset + n`` of a global batch of ``total``,
    as the losses of a data-parallel step take them.  A loss then returns
    this rank's share, and the ranks' shares sum to the one-process loss of
    the global batch: a per-row loss divides this rank's sum by the global
    denominator (``sum``); a batch-coupled loss (a contrastive term) is
    computed on rows gathered with gradient (``gather``), and its share is
    its value over the process count (``share``).  Random draws are made
    for the global batch and this rank's rows taken (``rows``), so the
    generator runs as in one process."""
    ctx: ParallelContext
    offset: int
    n: int
    total: int

    def rows(self, per_row: int = 1) -> tuple:
        """(start, stop, total) of this rank's part of a draw with
        ``per_row`` rows an image."""
        return self.offset * per_row, (self.offset + self.n) * per_row, self.total * per_row

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a denominator: no gradient) summed over the ranks."""
        return self.ctx.all_reduce(x.detach().clone())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [n, ...] -> the global batch [total, ...]."""
        return gather_rows(x, self.offset, self.total)

    def share(self, loss: torch.Tensor) -> torch.Tensor:
        """A loss every rank computes whole -> this rank's share of it."""
        return loss / self.ctx.process_count


def parallel_context(cfg: dict) -> Optional[ParallelContext]:
    """The data axis of ``MESH_DATA`` / ``MESH_FSDP`` / ``MESH_TENSOR`` over the
    process group (resolved as JAX resolves its mesh); None without a
    process group.  An fsdp or tensor axis above 1 raises."""
    mesh = MeshConfig(data=int(cfg.get("MESH_DATA", -1)), fsdp=int(cfg.get("MESH_FSDP", 1)),
                      tensor=int(cfg.get("MESH_TENSOR", 1)))
    if mesh.fsdp > 1 or mesh.tensor > 1:
        raise NotImplementedError(f"MESH_FSDP={mesh.fsdp}, MESH_TENSOR={mesh.tensor}: "
                                  f"{NEXT_SLICE}")
    mesh.resolve(process_count())
    return ParallelContext() if _initialized() else None


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
    the loss's over the process count, so for two ranks the sum of two
    halves is exact in any float type."""

    @staticmethod
    def forward(ctx, x, offset, total):
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[offset:offset + x.shape[0]] = x
        dist.all_reduce(buf)
        ctx.rows = (offset, x.shape[0])
        return buf

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        offset, n = ctx.rows
        return g[offset:offset + n], None, None


def gather_rows(x: torch.Tensor, offset: int, total: int) -> torch.Tensor:
    """The global batch [total, ...] of ``x``, this rank's rows from
    ``offset``; differentiable where ``x`` takes a gradient.  When each rank
    computes the loss of the gathered batch divided by the process count,
    the ranks' summed gradients are the one-process gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, offset, total)
    buf = x.new_zeros((total,) + tuple(x.shape[1:]))
    buf[offset:offset + x.shape[0]] = x
    dist.all_reduce(buf)
    return buf


def all_reduce_tree(leaves: list) -> list:
    """Sum a list of tensors over the ranks: one flat buffer per dtype, one
    all-reduce each; returns new tensors of the leaves' shapes."""
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, torch.split(flat, [leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return out

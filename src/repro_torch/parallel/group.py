"""The tensor-parallel group: the ranks that share one model's tensors.

``TPGroup`` holds a ``torch.distributed`` process group with this rank's
place in it and its device, and the three collectives the sharded forward
uses — ``all_reduce`` (a sum), ``all_gather`` (the list form, joined along
a dimension) and ``broadcast``.  Each adds one to ``COLLECTIVES[name]``,
so a run can report how many collectives a round issued (with gloo on
CUDA tensors each of them is staged through the host).

The sharded forward calls them through four ops with a gradient (the
Megatron f/g pair and two more), so that a training forward has a
backward through them:

* ``reduce``: a sum in the forward, the identity in the backward — a
  row-split product's partial sum that joins the replicated residual;
* ``copy``: the identity in the forward, a sum in the backward — a
  replicated tensor entering rank-local work (one copy on each such path);
* ``sum_both``: a sum both ways — a partial sum that feeds rank-local work
  again (mamba2's gated-norm sum of squares);
* ``gather``: an all-gather in the forward, the rank's slice of the
  gradient in the backward — the vocabulary-split logits.

Where no gradient is needed (every serving forward) each issues exactly
the collective it issued before the ops had a backward — in place, for
``reduce`` and ``sum_both`` — and ``copy`` none.  In a training forward
the collective runs on a copy of its input, never in place on a tensor
that autograd may have saved, and the backward's collectives count too.

``CountingGroup`` stands in for a ``TPGroup`` where no ranks run (the
dry run, ``launch/specs.py``): one rank's place in a group, whose
collectives return a tensor of the right shape without communicating and
report each call's kind and operand bytes to the cost counter, the
per-participant count.  The four ops go through it unchanged, so a train
step on it counts its backward's collectives too.

``make_train_groups`` carves a training world into this rank's model and
data groups (``launch.mesh.make_train_ranks``).

``init_tp`` joins the group: from torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``, or from explicit arguments and a ``FileStore`` path (the
tests, ``parallel.spawn``).  The default backend is NCCL for a CUDA device
and gloo for the CPU.  NCCL refuses two ranks on one device, so several
ranks on one card raise unless the caller passes ``backend="gloo"``; gloo
is never taken for CUDA tensors on its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
COLLECTIVE_TIMEOUT_S = 300  # a collective that waits longer for a rank raises


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(eq=False)
class TPGroup:
    """A process group of ``world`` ranks, this process being ``rank``, on
    ``device``; ``ranks`` are the group's global ranks in group order."""

    pg: Any
    rank: int
    world: int
    device: torch.device
    backend: str
    ranks: tuple

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, in place."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order."""
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks; its gradient passes through unchanged."""
        if _needs_grad(t):
            return _Reduce.apply(self, t)
        return self.all_reduce(t)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself; its gradient is summed over the ranks."""
        return _Copy.apply(self, t) if _needs_grad(t) else t

    def sum_both(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks; its gradient is summed over them too."""
        if _needs_grad(t):
            return _SumBoth.apply(self, t)
        return self.all_reduce(t)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``all_gather``; the gradient keeps this rank's slice."""
        if _needs_grad(t):
            return _Gather.apply(self, t, dim)
        return self.all_gather(t, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(t, src=self.ranks[src], group=self.pg)
        return t

    def new_group(self) -> "TPGroup":
        """A second process group over the same ranks (a communicator of its
        own: the async round gives the target and the draft one each).
        Every rank must call it, in the same order."""
        pg = dist.new_group(ranks=list(self.ranks), backend=self.backend)
        return dataclasses.replace(self, pg=pg)


class CountingGroup(TPGroup):
    """Rank ``rank`` of a group of ``world`` ranks along mesh axis ``axis``
    ("model", or "data" for the ranks a gradient is averaged over), with
    no process group: ``all_reduce`` and ``broadcast`` return their input,
    ``all_gather`` a tensor of the joined shape (uninitialised), and each
    call reports (kind, operand bytes) to the active cost counter
    (``kernels.work``).  ``COLLECTIVES`` counts real collectives only, so
    it is left alone."""

    def __init__(self, rank: int, world: int, device="meta", axis: str = "model"):
        super().__init__(pg=None, rank=rank, world=world, device=torch.device(device),
                         backend="none", ranks=tuple(range(world)))
        self.axis = axis

    def _record(self, kind: str, t: torch.Tensor) -> None:
        from repro_torch.kernels import work

        if work._COUNTER is not None:
            work._COUNTER.collective(kind, t.numel() * t.element_size(), self.axis, self.world)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._record("all_reduce", t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        self._record("all_gather", t)
        shape = list(t.shape)
        shape[dim] *= self.world
        return t.new_empty(shape)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._record("broadcast", t)
        return t

    def new_group(self) -> "CountingGroup":
        return CountingGroup(self.rank, self.world, self.device, self.axis)


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _summed(group: TPGroup, t: torch.Tensor) -> torch.Tensor:
    """The sum over the group of a contiguous copy of ``t``."""
    return group.all_reduce(t.clone(memory_format=torch.contiguous_format))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        return _summed(group, t)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, _summed(ctx.group, g)


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return _summed(group, t)

    @staticmethod
    def backward(ctx, g):
        return None, _summed(ctx.group, g)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.rank, ctx.dim, ctx.n = group.rank, dim, t.shape[dim]
        return group.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return None, g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None


def _device_key(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"
    return f"{socket.gethostname()}/cpu/{os.getpid()}"


def check_backend(backend: str, devices: list) -> None:
    """Raise when NCCL would put two of the ranks (``devices``: one key per
    rank naming its card) on one device."""
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(
            f"init_tp: {len(devices)} ranks on {len(set(devices))} CUDA device(s) — NCCL refuses "
            "two ranks on one device; pass backend='gloo' to share a card between ranks")


def init_tp(device=None, backend: str | None = None, *, rank: int | None = None,
            world_size: int | None = None, store_path: str | None = None) -> TPGroup:
    """Join the default process group and return it as a ``TPGroup``.

    Without ``rank`` the rank, world size and local rank come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, its
    rendezvous store); with it, ``world_size`` and ``store_path`` (a
    ``FileStore`` file that every rank names) must be given too.  A bare
    ``cuda`` device becomes ``cuda:<LOCAL_RANK mod devices>``.  NCCL with
    two ranks on one CUDA device raises; ``backend="gloo"`` shares a card."""
    device = resolve_device(device)
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        store, _, _ = next(dist.rendezvous("env://"))
    else:
        if world_size is None or store_path is None:
            raise ValueError("init_tp: an explicit rank needs world_size and store_path")
        local = rank
        store = dist.FileStore(store_path, world_size)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and world_size > 1:
        # every rank learns every rank's card before any NCCL call
        keys = dist.PrefixStore("repro_torch_tp_devices", store)
        keys.set(str(rank), _device_key(device))
        check_backend(backend, [keys.get(str(r)).decode() for r in range(world_size)])
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return TPGroup(pg=dist.group.WORLD, rank=rank, world=world_size, device=device,
                   backend=backend, ranks=tuple(range(world_size)))


def make_train_groups(world: TPGroup, mesh_model: int) -> tuple[TPGroup, TPGroup]:
    """(model group, data group) of this rank in a training ``world`` carved
    by ``launch.mesh.make_train_ranks``: the ranks its model is sharded
    over, and the ranks that hold the same shard.  Every rank makes every
    group (the model groups, then the data groups, each in order) with
    ``world``'s backend; a group of the whole world reuses its process
    group.  Every rank must call it, with the same ``mesh_model``."""
    from repro_torch.launch.mesh import make_train_ranks

    me = world.ranks[world.rank]
    mine = []
    for groups in make_train_ranks(world.world, mesh_model):
        for local in groups:
            ranks = tuple(world.ranks[r] for r in local)
            pg = world.pg if ranks == world.ranks else dist.new_group(ranks=list(ranks),
                                                                       backend=world.backend)
            if me in ranks:
                mine.append(TPGroup(pg=pg, rank=ranks.index(me), world=len(ranks),
                                    device=world.device, backend=world.backend, ranks=ranks))
    return mine[0], mine[1]


def shutdown_tp() -> None:
    """Leave the default process group (and every group made from it)."""
    if dist.is_initialized():
        dist.destroy_process_group()

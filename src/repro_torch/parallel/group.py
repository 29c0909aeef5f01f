"""The tensor-parallel group: the ranks that share one model's tensors.

``TPGroup`` holds a ``torch.distributed`` process group with this rank's
place in it and its device, and the four collectives the sharded forward
uses — ``all_reduce`` (a sum), ``all_gather`` (the list form, joined along
a dimension), ``reduce_scatter`` (the sum, this rank's slice of it along a
dimension) and ``broadcast``.  Each adds one to ``COLLECTIVES[name]``,
so a run can report how many collectives a round issued (with gloo on
CUDA tensors each of them is staged through the host).  On a ``serving``
group a floating ``all_reduce`` (16-bit or float32) is an all-gather and a
float32 sum in rank order (``_ordered_sum``), so that a row's sum does not
depend on the rows sent with it.

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
  gradient in the backward — the vocabulary-split logits, and a
  sequence-sharded tensor entering work that every rank repeats whole;
* ``split``: the rank's slice in the forward, an all-gather in the
  backward — the whole result of such work back onto the rank's rows;
* ``seq_copy``: an all-gather in the forward, a reduce-scatter in the
  backward — ``copy`` for a sequence-sharded tensor entering rank-local
  work (each rank's gradient of the whole tensor is partial: summed, and
  each rank keeps its rows);
* ``seq_reduce``: a reduce-scatter in the forward, an all-gather in the
  backward — ``reduce`` for a partial sum that leaves rank-local work
  onto a sequence-sharded residual.

``SeqGroup`` is a group seen from a residual stream whose rows are split
over its ranks (sequence parallelism, ``models/transformer.py``): its
``copy`` and ``reduce`` are ``seq_copy`` and ``seq_reduce`` along the
sequence, so that the code of a block that enters rank-local work by
``copy`` and leaves it by ``reduce`` runs unchanged on either layout.

Where no gradient is needed (every serving forward) each issues exactly
the collective it issued before the ops had a backward — in place, for
``reduce`` and ``sum_both`` — and ``copy`` none.  In a training forward
the collective runs on a copy of its input, never in place on a tensor
that autograd may have saved, and the backward's collectives count too.

``CountingGroup`` stands in for a ``TPGroup`` where no ranks run (the
dry run, ``launch/specs.py``): one rank's place in a group, whose
collectives return a tensor of the right shape without communicating and
report each call's kind and operand bytes to the cost counter, the
per-participant count (a reduce-scatter's operand is the whole input, as
the reference's HLO count reads operand sizes; a ``serving`` group's
16-bit all-reduce reports the all-gather it runs).  The four ops go
through it unchanged, so a train step on it counts its backward's
collectives too.

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

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0, "broadcast": 0}
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
    ordered: bool = False  # a floating all_reduce sums in float32 in rank order (``serving``)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, in place: the backend's all-reduce, or on
        a ``serving`` group for a floating tensor ``_ordered_sum``."""
        COLLECTIVES["all_reduce"] += 1
        if self.ordered and t.dtype in _ORDERED:
            return _ordered_sum(self, t)
        dist.all_reduce(t, group=self.pg)
        return t

    def serving(self) -> "TPGroup":
        """This group with ``ordered`` set, for serving a model: the engine's
        output must equal the greedy decode over the same ranks bit for
        bit, and a ring all-reduce's order follows the message's size
        (``_ordered_sum``).  The serving rank programs
        (``workers.spec_engine``, ``split_engine``, ``chain_engine``) take
        it; training and the dry run keep the backend's all-reduce."""
        return dataclasses.replace(self, ordered=True)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order."""
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice along ``dim`` (of ``t.shape[dim] / world``) of the
        sum over the ranks, a new tensor."""
        COLLECTIVES["reduce_scatter"] += 1
        parts = t.movedim(dim, 0).contiguous()
        out = parts.new_empty((parts.shape[0] // self.world,) + parts.shape[1:])
        dist.reduce_scatter_tensor(out, parts, group=self.pg)
        return out.movedim(0, dim)

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

    def split(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's slice along ``dim``; the gradient is all-gathered."""
        if _needs_grad(t):
            return _Split.apply(self, t, dim)
        return _slice(self, t, dim)

    def seq_copy(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``all_gather`` along ``dim``; the gradient is reduce-scattered."""
        if _needs_grad(t):
            return _SeqCopy.apply(self, t, dim)
        return self.all_gather(t, dim)

    def seq_reduce(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``reduce_scatter`` along ``dim``; the gradient is all-gathered."""
        if _needs_grad(t):
            return _SeqReduce.apply(self, t, dim)
        return self.reduce_scatter(t, dim)

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

    def __init__(self, rank: int, world: int, device="meta", axis: str = "model",
                 ordered: bool = False):
        super().__init__(pg=None, rank=rank, world=world, device=torch.device(device),
                         backend="none", ranks=tuple(range(world)), ordered=ordered)
        self.axis = axis

    def _record(self, kind: str, t: torch.Tensor) -> None:
        from repro_torch.kernels import work

        if work._COUNTER is not None:
            work._COUNTER.collective(kind, t.numel() * t.element_size(), self.axis, self.world)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._record("all_gather" if self.ordered and t.dtype in _ORDERED else "all_reduce", t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        self._record("all_gather", t)
        shape = list(t.shape)
        shape[dim] *= self.world
        return t.new_empty(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        self._record("reduce_scatter", t)
        shape = list(t.shape)
        shape[dim] //= self.world
        return t.new_empty(shape)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._record("broadcast", t)
        return t

    def new_group(self) -> "CountingGroup":
        return CountingGroup(self.rank, self.world, self.device, self.axis, self.ordered)

    def serving(self) -> "CountingGroup":
        return CountingGroup(self.rank, self.world, self.device, self.axis, ordered=True)


_ORDERED = (torch.bfloat16, torch.float16, torch.float32)


def _ordered_sum(group: TPGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group, in place, by an all-gather and a float32
    sum of the parts in rank order, rounded to ``t``'s dtype once.

    A ring all-reduce adds in the tensor's own dtype, and which rank starts
    an element's sum depends on the chunk the element falls in, so on the
    message's size: in bf16 (8 bits of mantissa, each add rounded) the rows
    of a verify of n rows and the one row of a decode step came out of the
    same partial sums a few ulps apart, enough to flip a greedy token.  In
    float32 too: over NCCL on 4 cards a row of 8 or 16 rows of 5120 or 8192
    values took other last bits than the row alone (F7,
    ``tools/f7_nccl.py``; on 2 cards, one addition, none did), the
    difference that flips a chain token in float32 at a near tie.
    Here an element's sum depends on its parts alone: the same on every
    rank and for every row count, and within one rounding of the float32
    sum the single-process product rounds once.  It moves (world - 1)
    parts to a rank where the ring moves 2 (world - 1) / world, and holds
    world copies of ``t``."""
    t_in = t.contiguous().reshape(-1)
    parts = t_in.new_empty((group.world, t_in.numel()))  # rank r's part is row r
    dist.all_gather_into_tensor(parts.view(-1), t_in, group=group.pg)
    acc = parts[0].float()
    for part in parts[1:]:
        acc += part
    return t.copy_(acc.view(t.shape))


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


def _slice(group: TPGroup, t: torch.Tensor, dim: int) -> torch.Tensor:
    n = t.shape[dim] // group.world
    return t.narrow(dim, group.rank * n, n)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(group, t, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.all_gather(g, ctx.dim), None


class _SeqCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.reduce_scatter(g, ctx.dim), None


class _SeqReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.all_gather(g, ctx.dim), None


@dataclasses.dataclass(eq=False)
class SeqGroup:
    """``group`` seen from a residual stream [B, rows, ...] whose sequence
    (``n`` rows in all) is split over its ranks: each holds ``rows =
    ceil(n / world)`` of them, rank r rows [r·rows, (r+1)·rows), the last
    ranks' rows past ``n`` padding (the residual's rows are independent, so
    a pad row never reaches a real one, and the pads are dropped wherever
    the whole sequence is formed).

    ``copy`` enters rank-local work by ``seq_copy`` and ``reduce`` leaves
    it by ``seq_reduce``, along dim 1; ``gather`` enters work that every
    rank repeats whole, ``split`` leaves it.  The whole sequence that
    ``copy`` and ``gather`` return holds the ``n`` real rows only, and
    ``reduce`` and ``split`` take it so; ``sum_both`` (a sum over the
    ranks of a tensor of the whole sequence), ``rank`` and ``world`` are
    ``group``'s."""

    group: TPGroup
    n: int

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world

    @property
    def rows(self) -> int:
        return -(-self.n // self.group.world)

    def _pad(self, t: torch.Tensor) -> torch.Tensor:
        extra = self.rows * self.world - t.shape[1]
        if not extra:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])], 1)

    def _trim(self, t: torch.Tensor) -> torch.Tensor:
        return t if t.shape[1] == self.n else t[:, :self.n]

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        return self._trim(self.group.seq_copy(t, 1))

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.seq_reduce(self._pad(t), 1)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._trim(self.group.gather(t, 1))

    def split(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.split(self._pad(t), 1)

    def rows_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, a whole-sequence tensor of rank-local
        work (no collective: its gradient is 0 on the other rows, a partial
        gradient as rank-local work's is)."""
        return self._pad(t)[:, self.rank * self.rows:(self.rank + 1) * self.rows]

    def sum_both(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.sum_both(t)


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

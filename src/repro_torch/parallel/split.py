"""Target and draft on disjoint rank groups: the disaggregated engine
(``repro``'s ``SpecEngine(mesh_target=A, mesh_draft=B)``; paper §3.1, the
draft on GPUs of its own, off the verify's critical path).

A world of ``n_target + n_draft`` ranks, one process each, is split
target-first (``launch/mesh.make_serving_ranks``), as the reference's
``make_serving_mesh`` splits devices: ranks
``[0, n_target)`` hold the target and ranks ``[n_target, world)`` the
draft, each role sharded over its own group by the tensor-parallel forward
(``models.api.make_model(..., group=)``; a role of one rank runs the
single-device model).  A rank holds its own role's model only: the other
role's is a ``StandIn`` that carries its config, with no weights, cache or
tree.

The roles exchange small tensors, each one broadcast of one packed int32
buffer over the world group from the sending role's leader (every rank of
a role holds the same bits, so any of them could send):

* the tree engine's plan, draft -> target: the verify batch's tokens,
  positions, rows, parent slots, valid flags and mask (``core/tree.py``'s
  ``BatchPlan`` but its node ids, which only the draft's tree reads) —
  ``Split.plan``; the verdict, target -> every rank, and in the async round
  the draft's prediction, draft -> every rank (``core/engine.py`` packs
  them);
* the chain engine's chain, draft -> target, the target's argmax and each
  request's first token, target -> every rank (``core/chain_engine.py``).

Under NCCL (one card per rank) a broadcast runs device to device on the
current stream and makes no host sync (``tools/split_nccl.py`` runs the
split so and counts one sync a round); under gloo (ranks sharing one card,
or the CPU) each is staged through the host.  Each adds one to
``COLLECTIVES["broadcast"]``.  A failed collective raises: nothing
carries on past it.

A fleet (``make_fleet``, ``init_fleet``: the router's replicas on disjoint
rank groups) carves a world of R x (n_target + n_draft) ranks into R such
splits, replica i on the ranks ``[i*g, (i+1)*g)``.  A replica's exchanges
run on its own ranks' group, so that no replica's round waits on another's
ranks, and a gloo group over the whole world carries the fleet's one
exchange per fleet round on the host (``Fleet.exchange_rows``; the serving
loop packs each replica's verdict into it, ``serving/runtime.py``).

  split = init_split(1, 1)                  # under torchrun, 2 ranks
  T, D = split.models(tcfg, dcfg)           # this role's model, the other's stand-in
  fleet = init_fleet(1, 1, replicas=2)      # under torchrun, 4 ranks: fleet.split is this
                                            # rank's replica's split
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import BatchPlan
from repro_torch.launch.mesh import make_serving_ranks
from repro_torch.models.api import StandIn, make_model
from repro_torch.parallel.group import TPGroup, init_tp

ROLES = ("target", "draft")


@dataclasses.dataclass(eq=False)
class Split:
    """This rank's place in a split world: its ``role``, its role's group
    (``group``: the ranks its model is sharded over), the ``world`` group
    the exchanges run on (the split's own ranks: the whole world, or one
    replica's share of it in a ``Fleet``), and each role's global ranks."""

    role: str
    group: TPGroup
    world: TPGroup
    target_ranks: tuple
    draft_ranks: tuple

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def model_group(self):
        """The group this rank's model is sharded over (None for a role of
        one rank: the single-device model, with no collective)."""
        return self.group if self.group.world > 1 else None

    def ranks(self, role: str) -> tuple:
        return self.target_ranks if role == "target" else self.draft_ranks

    def models(self, tcfg, dcfg):
        """(target, draft): this role's model on this rank's device (sharded
        over the role's group) and a ``StandIn`` for the other role."""
        own = make_model(tcfg if self.role == "target" else dcfg, self.device, self.model_group)
        return (own, StandIn(dcfg)) if self.role == "target" else (StandIn(tcfg), own)

    def share(self, buf, src: str, shape) -> torch.Tensor:
        """Role ``src``'s int32 ``buf`` of ``shape`` on every rank of the
        split: one broadcast over its ``world`` from that role's leader.  The ranks of
        ``src`` pass their buffer (the same bits on each of them), the
        others None."""
        if src == self.role:
            if tuple(buf.shape) != tuple(shape) or buf.dtype != torch.int32:
                raise ValueError(f"the {src}'s buffer is {buf.dtype}{tuple(buf.shape)}, "
                                 f"not int32{tuple(shape)}")
            buf = buf.contiguous()
        else:
            buf = torch.empty(shape, dtype=torch.int32, device=self.device)
        return self.world.broadcast(buf, src=self.world.ranks.index(self.ranks(src)[0]))

    def plan(self, plan, B: int, bs: int, S: int) -> BatchPlan:
        """The draft's verify batch on every rank: the draft's ranks keep
        their own ``plan``; the target's get its tokens, positions, rows,
        parent slots, valid flags and mask [B, bs, S] from one packed
        buffer, with no node ids."""
        buf = None
        if self.role == "draft":
            buf = torch.cat([plan.tokens, plan.positions, plan.rows, plan.parent_pos,
                             plan.valid.to(torch.int32),
                             plan.mask.reshape(B, bs * S).to(torch.int32)], 1)
        buf = self.share(buf, "draft", (B, 5 * bs + bs * S))
        if self.role == "draft":
            return plan
        tokens, positions, rows, parent_pos, valid = (
            buf[:, i * bs:(i + 1) * bs].contiguous() for i in range(5))
        return BatchPlan(node_ids=None, tokens=tokens, positions=positions, rows=rows,
                         mask=buf[:, 5 * bs:].reshape(B, bs, S).bool(), parent_pos=parent_pos,
                         valid=valid.bool())

    def agree_times(self, t_draft: float, t_target: float) -> tuple[float, float]:
        """Each role's leader's time on every rank of the split: one
        all-reduce over its ``world`` (the profile pass, so that every rank
        picks the same depth)."""
        mine = [t_draft, 0.0] if self.role == "draft" else [0.0, t_target]
        lead = self.group.rank == 0
        t = torch.tensor(mine if lead else [0.0, 0.0], dtype=torch.float64, device=self.device)
        return tuple(float(x) for x in self.world.all_reduce(t).cpu())


def _role_groups(world: TPGroup, pairs: list, own_pg=None) -> list:
    """Each pair's (replica pg, target pg, draft pg), made in one order on
    every rank (``dist.new_group`` is collective: another order hangs).
    With ``own_pg`` (one pair) the pair's ranks are ``world``'s, whose pg it
    is."""
    made = []
    for t, d in pairs:
        pg = own_pg if own_pg is not None else dist.new_group(ranks=list(t + d),
                                                              backend=world.backend)
        made.append((pg,) + tuple(dist.new_group(ranks=list(r), backend=world.backend)
                                  for r in (t, d)))
    return made


def _split(world: TPGroup, pair: tuple, pgs: tuple) -> Split:
    """This rank's ``Split`` of ``pair`` (its (target, draft) global ranks),
    which holds it, on the pair's groups ``pgs`` (``ordered`` as
    ``world``'s)."""
    target_ranks, draft_ranks = pair
    me = world.ranks[world.rank]
    ranks = target_ranks + draft_ranks
    own = TPGroup(pg=pgs[0], rank=ranks.index(me), world=len(ranks), device=world.device,
                  backend=world.backend, ranks=ranks, ordered=world.ordered)
    role = "target" if me in target_ranks else "draft"
    mine = target_ranks if role == "target" else draft_ranks
    group = TPGroup(pg=pgs[1 + ROLES.index(role)], rank=mine.index(me), world=len(mine),
                    device=world.device, backend=world.backend, ranks=mine,
                    ordered=world.ordered)
    return Split(role, group, own, target_ranks, draft_ranks)


def make_split(world: TPGroup, n_target: int) -> Split:
    """Split ``world`` target-first at ``n_target``: a process group for
    each role.  Every rank must call it, with the same ``n_target``."""
    pair = make_serving_ranks(world.ranks, n_target)
    return _split(world, pair, _role_groups(world, [pair], world.pg)[0])


def init_split(n_target: int, n_draft: int, device=None, backend=None) -> Split:
    """Join a world of ``n_target + n_draft`` ranks (``init_tp`` from
    torchrun's environment) and split it.
    NCCL is the default on CUDA, one card per rank; several ranks on one
    card raise unless ``backend="gloo"``."""
    world = init_tp(device, backend)
    if world.world != n_target + n_draft:
        raise ValueError(f"a split of {n_target} target + {n_draft} draft ranks needs a world of "
                         f"{n_target + n_draft}, got {world.world}")
    return make_split(world, n_target)


@dataclasses.dataclass(eq=False)
class Fleet:
    """This rank's place in a fleet of R split replicas (the router's
    replicas on disjoint rank groups, ``serving.router``): its ``replica``,
    that replica's ``split`` (whose exchanges run on the replica's ranks
    alone), each replica's (target ranks, draft ranks) ``pairs``, and
    ``exchange``, a gloo group over the whole world on the host
    for the one exchange of each fleet round (``exchange_rows``)."""

    replica: int
    split: Split
    pairs: tuple
    exchange: TPGroup
    exchanges: int = 0  # fleet exchanges made, counted apart from COLLECTIVES

    @property
    def replicas(self) -> int:
        return len(self.pairs)

    def row_of(self, replica: int) -> int:
        """The row of an exchange that stands for ``replica``: its target
        leader's (every rank of a replica holds the same verdict)."""
        return self.exchange.ranks.index(self.pairs[replica][0][0])

    def exchange_rows(self, row: np.ndarray) -> np.ndarray:
        """Every rank's int32 ``row`` (of one length on every rank) as
        [world, n] on every rank: one gloo all-gather on the host, which
        makes no CUDA sync under either backend."""
        self.exchanges += 1
        mine = torch.from_numpy(np.ascontiguousarray(row, np.int32))
        parts = [torch.empty_like(mine) for _ in range(self.exchange.world)]
        dist.all_gather(parts, mine, group=self.exchange.pg)
        return torch.stack(parts).numpy()  # repro_torch: disable=HOTSYNC — gloo's CPU tensors


def make_fleet(world: TPGroup, n_target: int, n_draft: int, replicas: int) -> Fleet:
    """Carve ``world`` into ``replicas`` splits of ``n_target`` target +
    ``n_draft`` draft ranks (``make_serving_ranks``) and join this rank's.
    Every rank makes every replica's groups (the replica's, then its two
    roles'), replica by replica, then the fleet's gloo group: the same
    order on every rank.  A world of other than ``replicas * (n_target +
    n_draft)`` ranks raises."""
    pairs = make_serving_ranks(world.ranks, n_target, n_draft, replicas=replicas)
    pairs = [pairs] if replicas == 1 else pairs
    pgs = _role_groups(world, pairs, world.pg if replicas == 1 else None)
    exchange = TPGroup(pg=dist.new_group(ranks=list(world.ranks), backend="gloo"),
                       rank=world.rank, world=world.world, device=torch.device("cpu"),
                       backend="gloo", ranks=world.ranks)
    me = world.ranks[world.rank]
    i = next(i for i, (t, d) in enumerate(pairs) if me in t + d)
    return Fleet(i, _split(world, pairs[i], pgs[i]), tuple(pairs), exchange)


def init_fleet(n_target: int, n_draft: int, replicas: int, device=None, backend=None) -> Fleet:
    """Join a world of ``replicas * (n_target + n_draft)`` ranks (``init_tp``
    from torchrun's environment) and carve it into the fleet's splits."""
    world = init_tp(device, backend)
    return make_fleet(world, n_target, n_draft, replicas)

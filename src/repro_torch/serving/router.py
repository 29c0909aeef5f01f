"""ShardedServingRuntime (``repro.serving.router``) — one global request
queue dispatched over N SpecEngine replicas with depth-aware routing.

Each replica is a (target group, draft group) pair carved by
``repro_torch.launch.mesh.make_serving_devices(..., replicas=N)``, driven by
its own ``EngineStepper`` — the same per-slot admit/absorb/retire lifecycle
and the same fleet loop (``ServingRuntimeBase``) the single-engine runtime
uses, so the byte-identical contract holds per request whichever replica
served it, and the single-engine runtime is the N = 1 case.

Routing (``ServingRuntimeBase._route``): a popped request lands on the
replica with the lowest occupancy fraction among those with a free slot;
equal load breaks on deadline slack, then FIFO — the replica that has gone
longest since its last admission wins — so equal load spreads round-robin
instead of piling onto replica 0.

One global round of the fleet loop = every busy replica dispatches its
round, the clock advances once, then every replica absorbs, retires and
backfills.  With async rounds a replica's dispatch enqueues its verify and
its lookahead without waiting for the card, so the host moves on to the
next replica's dispatch, and each replica makes its one host sync per
round in its absorb (a lockstep replica makes it inside its step).  When
the carved pairs fall back to one shared device, the replicas share one
engine object and one card: every round of every replica is state of its
own session (its ``EngineState`` and its ``RoundInFlight``), and the
engine holds only its models, its config and its two streams.
Telemetry is one ``ServerStats`` per replica, merged by
``stats.merge_summary`` / ``fleet_report`` into global TTFT and throughput
plus the per-replica occupancy breakdown.

Replicas on disjoint rank groups (``fleet=``, a ``parallel.split.Fleet``
of R splits, one process per rank; the serving-side half of SwiftSpec's
scaling) run this same loop on every rank: a rank's own replica is its
split engine, every other one an ``EngineMirror`` (``fleet_engines``) kept
by the fleet's one exchange per round (``ServingRuntimeBase._process_round``).
Routing, admission and retirement read only host state that every rank
holds alike, so ``stats``, ``summary()``, ``report()`` and ``replica_of()``
are the same on every rank, and the single controller's.

  engines = fleet_engines(fleet, engine)    # engine: this rank's replica's split engine
  rt = ShardedServingRuntime(engines, tparams, dparams, n_slots=2,
                             clock=VirtualClock(), fleet=fleet)
"""

from __future__ import annotations

from typing import Callable

from repro_torch.serving.queue import RequestQueue
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.runtime import EngineMirror, EngineStepper, ServingRuntimeBase
from repro_torch.serving.stats import ServerStats, fleet_report, merge_summary


class ShardedServingRuntime(ServingRuntimeBase):
    """N-replica continuous batching over one global ``RequestQueue``.

    ``engines`` is a list of SpecEngine replicas (passing the same engine
    object N times is valid — states are per replica — and is what the
    shared-device fallback does).  ``tparams``/``dparams`` are either one
    set shared by every replica or a list with one entry per replica
    (weights resident on that replica's devices).

    With ``fleet`` (a ``parallel.split.Fleet``) the replicas run on
    disjoint rank groups: ``engines[fleet.replica]`` is this rank's own
    replica's split engine and every other entry an ``EngineMirror``
    (``fleet_engines``); the params are this rank's own.  ``tracer``
    records the own replica's spans and the router's, ``metrics`` every
    replica's (the mirrors update theirs)."""

    def __init__(self, engines, tparams, dparams, n_slots: int, *,
                 queue: RequestQueue | None = None,
                 clock=None,
                 stream: Callable[[int, list, bool], None] | None = None,
                 tracer=None,
                 metrics=None,
                 scheduler=None,
                 fleet=None):
        if not engines:
            raise ValueError("need at least one engine replica")
        self._init_admission(queue, clock, tracer, metrics)
        tps = tparams if isinstance(tparams, list) else [tparams] * len(engines)
        dps = dparams if isinstance(dparams, list) else [dparams] * len(engines)
        if not (len(tps) == len(dps) == len(engines)):
            raise ValueError("per-replica params must match the engine count")
        if fleet is not None and (len(engines) != fleet.replicas or any(
                isinstance(e, EngineMirror) == (i == fleet.replica)
                for i, e in enumerate(engines))):
            raise ValueError(f"a fleet of {fleet.replicas} replicas serves this rank's engine "
                             f"at index {fleet.replica} and a mirror at every other "
                             "(fleet_engines)")
        self._init_fleet([
            EngineStepper(eng, tp, dp, n_slots,
                          stats=ServerStats(), stream=stream,
                          results=self.results, replica=i,
                          tracer=NULL_TRACER if isinstance(eng, EngineMirror) else self.tracer,
                          metrics=self.metrics,
                          scheduler=scheduler)
            for i, (eng, tp, dp) in enumerate(zip(engines, tps, dps))
        ], fleet)

    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.steppers)

    @property
    def stats(self) -> list[ServerStats]:
        """Per-replica telemetry (merge with ``summary()``/``report()``)."""
        return [s.stats for s in self.steppers]

    def summary(self) -> dict:
        # per-replica accept-depth histograms may have different bucket
        # edges (replicas can run different draft depths) — merge_summary
        # unions the edges instead of summing counts positionally
        hists = [h for _, h in self.metrics.histogram_family("serving_accept_depth")]
        return merge_summary(self.stats, accept_hists=hists or None)

    def report(self) -> str:
        return fleet_report(self.stats)

    def replica_of(self, rid: int) -> int | None:
        """Which replica served (or is serving) a request, None if unknown."""
        for i, st in enumerate(self.steppers):
            if rid in st.stats.records:
                return i
        return None


def fleet_engines(fleet, engine) -> list:
    """The ``engines`` of a fleet's ``ShardedServingRuntime`` on this rank:
    ``engine`` (its own replica's) at ``fleet.replica``, a mirror of it at
    every other index."""
    return [engine if i == fleet.replica else EngineMirror(engine)
            for i in range(fleet.replicas)]

"""Continuous-batching serving (``repro.serving.runtime``): per-slot
request lifecycles over SpecEngine.

The engine's round (``EngineSession.step``) always advances all B batch
rows; ``EngineStepper`` gives each row (a *slot*) its own request lifecycle:

  admit   — install an arrived request into a free slot (solo prefill into
            the slot's cache rows, per-slot tree re-seed) — neighbors keep
            decoding untouched;
  decode  — mixed-progress rounds: every occupied slot emits its verified
            tokens each round, streamed to the caller as they land;
  retire  — on EOS / max_new / cache budget the slot is released (tree
            parked, KV rows zeroed) and immediately backfilled from the
            queue on the next loop turn.

``ContinuousBatchingRuntime`` drives ONE stepper over a ``RequestQueue``;
``ShardedServingRuntime`` (``repro_torch.serving.router``) drives N of them
over one global queue with depth-aware routing.  Both share the same
stepper and the same fleet loop, so the slot lifecycle has exactly one
implementation.  Because greedy verification makes each row's emitted
stream equal target-only greedy decoding regardless of what the other rows
are doing, a request's output is byte-identical to a solo ``generate()``
run no matter when it was admitted or which replica served it
(tests/test_torch_serving.py and tests/test_torch_router.py assert this
against the port's solo run and the reference's runtimes).

With ``async_rounds`` a round is dispatched by ``EngineStepper.step`` (the
target's verify on one CUDA stream, the draft's lookahead on another) and
reconciled by ``absorb_round``, which makes the round's one host sync.

An engine that several processes run — models sharded over a group of
ranks, or target and draft split over disjoint ones (``parallel/split.py``)
— is served by the same loop on every rank.  Each round's ``StepResult`` is
the same on every rank (the verdict crosses to every rank before the
sync), so with a ``VirtualClock`` every rank admits, steps, absorbs and
retires alike; a ``WallClock`` is refused there.

Replicas on disjoint rank groups (a ``parallel.split.Fleet``: R splits of
one world, one process per rank) run the same fleet loop on every rank.
A rank runs its own replica's engine; every other replica is an
``EngineMirror``, whose stepper holds the same slots, ``ServerStats``,
metric handles and depth controller but no session.  A fleet round is:
the own replica dispatches, the clock ticks once (by the deepest replica's
depth, the mirrors' included), the own replica reconciles (its one host
sync), then ONE exchange on the host carries every replica's packed
``StepResult`` (and its round counts and an error flag) to every rank, and
every rank absorbs every replica's result in replica order.  So every rank
routes, admits and retires alike, and holds every replica's stats.  A
failure in a replica's round sets its flag, and every rank raises in that
fleet round.

The clock is injectable: ``WallClock`` replays a trace against real time
(sleeping until the next arrival when idle); ``VirtualClock`` advances a
deterministic amount per engine round, so tests and benchmarks get
reproducible admission schedules independent of host speed.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.engine import RoundInFlight, SpecStats, StepResult, absorb_emitted
from repro_torch.obs.clock import monotonic
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP_SPAN, NULL_TRACER
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import (
    AdaptiveDepthController,
    SchedulerConfig,
    deadline_slack,
)
from repro_torch.serving.stats import ServerStats

# accepted-depth histogram bucket for "replica admitted/finished" style
# counters is per-engine (0..bs); TTFT spans queueing so it gets the wide
# latency buckets below (virtual and wall clocks both land inside them)
TTFT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class WallClock:
    def __init__(self):
        self._t0 = monotonic()

    def now(self) -> float:
        return monotonic() - self._t0

    def reset(self) -> None:
        """Re-zero the serving timeline (run() calls this so construction-time
        work — weights, kernel builds — doesn't consume the trace's arrival
        schedule)."""
        self._t0 = monotonic()

    def on_round(self, depth: int | None = None) -> None:
        pass  # real time advances by itself

    def wait_until(self, t: float) -> None:
        d = t - self.now()
        if d > 0:
            time.sleep(d)


class VirtualClock:
    """Deterministic clock: ``round_dt`` virtual seconds per engine round,
    plus ``expand_dt`` per draft-tree expansion the round actually ran —
    the cost model that makes adaptive draft depth *measurable* on the
    virtual timeline (a depth-1 round is cheaper than a depth-4 round, as
    on hardware where each expansion is a serialized draft forward pass).
    ``expand_dt=0`` (the default) keeps the legacy fixed-cost rounds."""

    def __init__(self, round_dt: float = 1.0, expand_dt: float = 0.0):
        self._t = 0.0
        self.round_dt = round_dt
        self.expand_dt = expand_dt

    def now(self) -> float:
        return self._t

    def reset(self) -> None:
        self._t = 0.0

    def on_round(self, depth: int | None = None) -> None:
        self._t += self.round_dt + (self.expand_dt * depth if depth else 0.0)

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)


class EngineMirror:
    """Another replica's engine, as a rank of a fleet of processes sees it
    (``parallel.split.Fleet``): the config and KV budget of ``like``, this
    rank's own replica's engine (every replica is built alike), and nothing
    to run.  Its ``EngineStepper`` keeps the replica's host-side state from
    the fleet's exchange."""

    multi_process = True

    def __init__(self, like):
        self._like = like

    @property
    def cfg(self):
        return self._like.cfg

    @property
    def plen_budget(self) -> int:
        return self._like.plen_budget


ROUND_COUNTS = ("draft_steps", "spec_rounds", "spec_commits")  # a round's SpecStats beside
# add_round's, carried by the fleet exchange for the mirrors


def pack_round(res, counts, n_slots: int, bs: int, failed: bool) -> np.ndarray:
    """One rank's row of a fleet exchange, int32: [failed, present, the
    ROUND_COUNTS deltas, emitted [n_slots, bs + 1], n_emitted, n_accepted]
    (``res`` None: this rank's replica did not step)."""
    row = np.zeros(5 + n_slots * (bs + 3), np.int32)
    row[0] = failed
    if res is not None:
        row[1] = 1
        row[2:5] = counts
        row[5:] = np.concatenate([np.asarray(res.emitted).reshape(-1), res.n_emitted,
                                  res.n_accepted])
    return row


def unpack_round(row: np.ndarray, n_slots: int, bs: int):
    """(StepResult, ROUND_COUNTS deltas) of a replica's exchanged row."""
    e = n_slots * (bs + 1)
    body = row[5:]
    return (StepResult(body[:e].reshape(n_slots, bs + 1), body[e:e + n_slots],
                       body[e + n_slots:]), tuple(int(x) for x in row[2:5]))


@dataclasses.dataclass
class _Active:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    plen: int  # host mirror of the slot's device prefix length
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False


class EngineStepper:
    """The per-engine admit/absorb/retire loop over one SpecEngine state.

    One stepper owns one ``EngineState`` of ``n_slots`` rows plus the
    host-side slot bookkeeping; the serving runtimes own the queue, the
    clock, and the decision of WHICH stepper a request lands on.  All
    device work (``admit`` prefills, ``step`` rounds) is enqueued without a
    host sync (on the engine's two streams when it runs async rounds); the
    host waits only in the round's verified-token transfer.

    Over an ``EngineMirror`` (another replica of a fleet of processes) it
    is a mirror: no session; ``admit`` and ``_retire`` keep the books only,
    ``step`` only takes the round's depth, and ``mirror_round`` then
    ``absorb_round`` fold in the replica's exchanged result.
    """

    def __init__(self, engine, tparams, dparams, n_slots: int, *,
                 stats: ServerStats | None = None,
                 stream: Callable[[int, list, bool], None] | None = None,
                 results: dict | None = None,
                 replica: int = 0,
                 tracer=None,
                 metrics: MetricsRegistry | None = None,
                 scheduler: SchedulerConfig | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.engine, self.tparams, self.dparams = engine, tparams, dparams
        self.n_slots = n_slots
        self.replica = replica
        self.stats = stats if stats is not None else ServerStats()
        self.stream = stream
        self.results = results if results is not None else {}
        self.slots: list[_Active | None] = [None] * n_slots
        # the engine's KV-budget bound (shared with generate(), so serving
        # truncates at exactly the same token as a solo run)
        self.plen_limit = engine.plen_budget
        # ---- observability (repro_torch.obs): spans on this replica's track, and
        # cached metric handles so the hot path touches one object each
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.track = f"replica{replica}"
        self._round_span = NOOP_SPAN
        # the bound round API: params + EngineState + tracer, one per replica
        # (none for a mirror: another rank group runs that replica)
        self.mirror = isinstance(engine, EngineMirror)
        self.session = None if self.mirror else engine.session(
            tparams, dparams, n_slots=n_slots, tracer=self.tracer,
            track=self.track)
        self.spec_stats = SpecStats()  # engine-level round accounting
        rep = str(replica)
        m = self.metrics
        self._m_rounds = m.counter("serving_rounds_total", replica=rep)
        self._m_admitted = m.counter("serving_admitted_total", replica=rep)
        self._m_finished = m.counter("serving_finished_total", replica=rep)
        self._m_truncated = m.counter("serving_kv_truncations_total", replica=rep)
        self._m_tokens = m.counter("serving_tokens_total", replica=rep)
        # exact per-depth distribution: one bucket per possible accepted
        # count (0..bs) — ROADMAP #2's adaptive-depth signal
        self._m_accept = m.histogram(
            "serving_accept_depth", buckets=tuple(range(engine.cfg.bs + 1)),
            replica=rep)
        self._m_ttft = m.histogram("serving_ttft_seconds", buckets=TTFT_BUCKETS,
                                   replica=rep)
        self._m_occupancy = m.series("serving_occupancy", replica=rep)
        self._m_spec_commits = m.counter("serving_spec_commits_total", replica=rep)
        self._m_depth = m.series("serving_round_depth", replica=rep)
        # ---- adaptive draft depth (repro_torch.serving.scheduler): per-slot
        # acceptance EMAs seeded from the accept-depth histogram above; None
        # keeps the engine's fixed global d (the pre-scheduler behavior)
        self.depth_ctl = None
        if scheduler is not None:
            self.depth_ctl = AdaptiveDepthController(
                scheduler, n_slots, default_depth=engine.cfg.d,
                seed_hist=self._m_accept)
        # the depth the most recent step() ran at (the round's cost driver,
        # read by the fleet loop's clock and the round-depth series)
        self.last_round_depth = engine.cfg.d

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The session's EngineState (None for a mirror)."""
        return None if self.session is None else self.session.state

    @state.setter
    def state(self, s):
        self.session.state = s

    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    @property
    def load(self) -> float:
        """Occupancy fraction in [0, 1] — the routing signal."""
        return self.occupied / self.n_slots

    def deadline_slack(self, now: float) -> float:
        """Tightest remaining deadline slack across this replica's occupied
        slots (+inf when none is deadlined) — the router's SLO-pressure
        tie-break (see ``ServingRuntimeBase._route``)."""
        return deadline_slack(self.slots, now)

    # ------------------------------------------------------------------
    def admit(self, req: Request, now: float) -> int:
        """Install ``req`` into the first free slot; returns the slot.  The
        caller supplies ONE timestamp used for both the arrival gate and the
        ``on_admit`` stamp, so ``queue_s``/TTFT cannot be skewed by clock
        reads straddling the prefill dispatch."""
        slot = self.slots.index(None)
        if not self.mirror:  # a mirror's replica prefills on its own ranks
            with self.tracer.span("admit_prefill", self.track,
                                  args={"rid": req.rid, "slot": slot,
                                        "plen": int(req.prompt.size)}):
                self.session.admit_slot(slot, req.prompt)
        self.slots[slot] = _Active(req=req, plen=int(req.prompt.size))
        self.stats.on_admit(req.rid, slot, req.arrival_s, now, replica=self.replica,
                            deadline_s=req.deadline_s, priority=req.priority)
        if self.depth_ctl is not None:
            self.depth_ctl.seed_slot(slot)
        self._m_admitted.inc()
        return slot

    def step(self):
        """Dispatch one engine round for every slot.  Lockstep: runs the full
        round and returns its StepResult.  Async (``cfg.async_rounds``):
        dispatches verify + the speculative next-round draft and returns the
        ``RoundInFlight`` WITHOUT syncing — the host is free to step the
        other replicas (the two-stage pipeline: one verify and one draft
        outstanding per replica) until ``absorb_round`` reconciles it.

        With an adaptive-depth scheduler bound, the round's effective depth
        is the controller's decision for the CURRENT occupancy (max depth
        bucket over occupied slots' acceptance EMAs); otherwise the engine's
        fixed global ``d``.  Either way ``last_round_depth`` records it for
        the fleet clock's cost model and the round-depth series.

        Opens this replica's ``round`` span; ``absorb_round`` closes it (or
        ``abort_round`` on a failed fleet turn), so the span brackets
        dispatch through absorption — the engine's phase spans
        (verify/draft/sync/reroot) plus ``absorb`` are its children."""
        self._round_span = self.tracer.begin("round", self.track)
        try:
            depth = None
            if self.depth_ctl is not None:
                depth = self.depth_ctl.round_depth(
                    [s is not None for s in self.slots])
            self.last_round_depth = self.engine.cfg.d if depth is None else depth
            self._round_span.set("depth", self.last_round_depth)
            if self.mirror:  # the replica's own ranks dispatch it
                return None
            if self.engine.cfg.async_rounds:
                return self.session.begin_round(depth=depth)
            return self.session.step(stats=self.spec_stats, depth=depth)
        except BaseException:
            # a failed dispatch must not leak the open round span
            self._round_span.end()
            self._round_span = NOOP_SPAN
            raise

    def absorb_round(self, res, now: float) -> None:
        """Fold one round's outcome into every occupied slot, retiring the
        rows that finished (EOS / max_new / cache budget).  An in-flight
        async round is reconciled here — prediction mismatches on
        unoccupied rows are ignored (``live`` mask), since parked trees
        never reach verification and admission overwrites the row.

        The round span closes via try/finally: an absorb that raises (a
        failing stream callback, a poisoned record) must leave the tracer
        balanced, not with this replica's round span open forever."""
        try:
            res = self.resolve(res)
            self._m_occupancy.append(now, self.occupied)  # pre-retire, as stats does
            self._m_depth.append(now, self.last_round_depth)
            with self.tracer.span("absorb", self.track):
                for slot, act in enumerate(self.slots):
                    if act is None:
                        continue
                    self._absorb(slot, act, res, now)
                    if act.done:
                        self._retire(slot, act, now)
            self._m_rounds.inc()
        finally:
            self._round_span.end()
            self._round_span = NOOP_SPAN

    def resolve(self, res):
        """The round's ``StepResult``: an in-flight async round is
        reconciled here (its one host sync; prediction mismatches on
        unoccupied rows are ignored)."""
        if isinstance(res, RoundInFlight):
            pre = self.spec_stats.spec_commits
            res = self.session.reconcile(
                res, stats=self.spec_stats,
                live=[s is not None for s in self.slots])
            if self.spec_stats.spec_commits > pre:
                self._m_spec_commits.inc()
        return res

    def round_counts(self) -> np.ndarray:
        """The ROUND_COUNTS fields of ``spec_stats`` (their difference over
        a round is what the fleet exchange carries for the mirrors)."""
        return np.array([getattr(self.spec_stats, k) for k in ROUND_COUNTS], np.int64)

    def mirror_round(self, res, counts) -> None:
        """Fold another replica's round into this mirror's ``spec_stats``:
        its rows' emitted and accepted counts and its ROUND_COUNTS deltas,
        as its own ranks counted them."""
        self.spec_stats.add_round(res.n_emitted, res.n_accepted)
        for k, n in zip(ROUND_COUNTS, counts):
            setattr(self.spec_stats, k, getattr(self.spec_stats, k) + n)
        if counts[ROUND_COUNTS.index("spec_commits")]:
            self._m_spec_commits.inc()

    def abort_round(self, res) -> None:
        """Abandon a dispatched round whose ``absorb_round`` will never run
        (another replica's absorb raised and the fleet loop is unwinding).
        An in-flight async round is reconciled and its result discarded —
        the session's buffers were donated into the round, so dropping the
        ``RoundInFlight`` on the floor would orphan the session — and the
        open round span is closed so the tracer stays balanced."""
        try:
            if isinstance(res, RoundInFlight):
                self.session.reconcile(
                    res, live=[s is not None for s in self.slots])
        finally:
            self._round_span.end()
            self._round_span = NOOP_SPAN

    def _absorb(self, slot: int, act: _Active, res, now: float) -> None:
        """Append one StepResult row's verified tokens up to EOS/max_new,
        stream them, update the plen mirror."""
        # per-request eos/max_new fall back to the engine's, so the
        # byte-identical contract vs solo generate() holds for any SpecConfig
        eos = act.req.eos_id if act.req.eos_id is not None else self.engine.cfg.eos_id
        max_new = act.req.max_new if act.req.max_new is not None else self.engine.cfg.max_new
        new, act.done = absorb_emitted(
            act.out, res.emitted[slot], res.n_emitted[slot], max_new, eos)
        act.plen += int(res.n_emitted[slot])
        if act.plen >= self.plen_limit and not act.done:  # cache budget
            act.done = act.truncated = True
        first = self.stats.records[act.req.rid].first_token_s is None
        self.stats.on_tokens(act.req.rid, len(new), int(res.n_accepted[slot]), now)
        self._m_accept.observe(int(res.n_accepted[slot]))
        if self.depth_ctl is not None:  # the same measurement feeds the EMA
            self.depth_ctl.observe(slot, int(res.n_accepted[slot]))
        if new:
            self._m_tokens.inc(len(new))
            if first:
                self._m_ttft.observe(now - act.req.arrival_s)
        if self.stream is not None and (new or act.done):
            self.stream(act.req.rid, new, act.done)

    def _retire(self, slot: int, act: _Active, now: float) -> None:
        self.results[act.req.rid] = act.out
        if not self.mirror:
            with self.tracer.span("retire", self.track, args={"rid": act.req.rid,
                                                              "slot": slot}):
                self.session.release_slot(slot)
        self.slots[slot] = None
        if self.depth_ctl is not None:  # acceptance history dies with the request
            self.depth_ctl.clear_slot(slot)
        self.stats.on_finish(act.req.rid, now, truncated=act.truncated)
        self._m_finished.inc()
        if act.truncated:
            self._m_truncated.inc()


class ServingRuntimeBase:
    """The serve loop over a fleet of steppers: trace submission, arrival
    feeding, routed admission, the round loop, and idle handling — shared by
    the single-engine runtime (a 1-stepper fleet) and the sharded runtime
    (N steppers), so both admission semantics and the round schedule have
    exactly one implementation.

    Subclasses call ``_init_admission`` then ``_init_fleet`` from their
    constructors.
    """

    def _init_admission(self, queue: RequestQueue | None, clock,
                        tracer=None, metrics: MetricsRegistry | None = None) -> None:
        self.queue = queue if queue is not None else RequestQueue()
        self.clock = clock if clock is not None else WallClock()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_queue_depth = self.metrics.series("serving_queue_depth")
        self.results: dict[int, list] = {}
        # trace entries whose arrival time is still in the future; they join
        # the queue when the clock reaches them, so BOTH admission gates (the
        # queue cap and the prompt-length bound) shed on ARRIVED traffic —
        # live semantics — not at trace-submission time
        self._pending: collections.deque[Request] = collections.deque()
        self._started = False  # pre-run submissions gate against t=0

    def submit(self, req: Request) -> bool:
        """Queue a request.  A request with a future ``arrival_s`` is held
        outside the queue and faces BOTH admission gates — the queue cap and
        the engine's prompt-length bound — when its arrival time comes, so
        ``RequestQueue.submitted``/``rejected`` count live traffic, not trace
        length.  An already-arrived request is adjudicated immediately:
        rejected (False) when its prompt cannot fit the cache budget or the
        queue is full."""
        # before run() the serving timeline hasn't started: arrivals compare
        # against t=0, not against however long engine construction took
        now = self.clock.now() if self._started else 0.0
        if req.arrival_s > now:
            if self._pending and req.arrival_s < self._pending[-1].arrival_s:
                raise ValueError("submissions must be ordered by arrival_s")
            self._pending.append(req)
            return True
        # a live submit after its arrival time arrives NOW on the serving
        # timeline, keeping queue ordering intact (a copy, so the caller's
        # Request is not mutated); trace entries fed by _feed_arrived keep
        # their true arrival_s — queueing delay belongs in their TTFT
        if req.arrival_s < now:
            req = dataclasses.replace(req, arrival_s=now)
        return self._arrive(req)

    def _arrive(self, req: Request) -> bool:
        """Run the arrival-time admission gates for one request."""
        if req.prompt.size >= self._plen_limit:
            return self.queue.reject(req)
        return self.queue.submit(req)

    def _feed_arrived(self) -> None:
        """Move trace entries whose arrival time has passed through the
        arrival gates (where the cap / prompt bound may shed them)."""
        now = self.clock.now()
        while self._pending and self._pending[0].arrival_s <= now:
            self._arrive(self._pending.popleft())

    def submit_trace(self, requests) -> int:
        """Submit an iterable of Requests (arrival-ordered); returns #accepted
        (future arrivals count as accepted here and are adjudicated on
        arrival)."""
        return sum(1 for r in requests if self.submit(r))

    def _next_arrival(self) -> float | None:
        nxt = self.queue.next_arrival()
        if nxt is None and self._pending:
            nxt = self._pending[0].arrival_s
        return nxt

    def _start_run(self) -> bool:
        """First run() call re-zeros the clock (construction-time work must
        not consume the trace's arrival schedule); later runs
        keep the original timeline.  Returns True on the first start."""
        if self._started:
            return False
        self._started = True
        self.clock.reset()
        return True

    # ---- the fleet loop ----------------------------------------------
    def _init_fleet(self, steppers: list[EngineStepper], fleet=None) -> None:
        """``fleet``: a ``parallel.split.Fleet`` when the steppers are
        replicas on disjoint rank groups (this rank's own replica's stepper
        at ``fleet.replica``, mirrors elsewhere)."""
        if isinstance(self.clock, WallClock) and any(st.engine.multi_process for st in steppers):
            raise ValueError("an engine that several processes run (a split, a group of "
                             "ranks, or a fleet of them) serves on a VirtualClock: on a wall "
                             "clock the ranks would admit at different rounds")
        if fleet is None and any(st.mirror for st in steppers):
            raise ValueError("a mirror of another replica steps only in a fleet of processes "
                             "(fleet=)")
        self.steppers = steppers
        self.fleet = fleet
        self.rounds = 0  # global rounds run (fleet rounds)
        # replicas could in principle differ; admission must fit the tightest
        self._plen_limit = min(s.plen_limit for s in steppers)
        self._seq = 0
        self._last_dispatch = [-1] * len(steppers)

    @property
    def occupied(self) -> int:
        return sum(s.occupied for s in self.steppers)

    def _route(self, now: float) -> int | None:
        """Pick the admission target: least-loaded stepper (occupancy
        fraction) among those with a free slot.  Equal load breaks on
        deadline slack — the replica whose in-flight work has the MOST
        remaining slack wins, so a new admission (whose rounds every
        co-resident request shares) is steered away from the replica that
        must finish something soonest.  Replicas with no deadlined work
        have infinite slack and tie, falling through to the FIFO tie-break
        — the stepper whose last admission is oldest — so deadline-free
        fleets keep the round-robin spread exactly.  None when the fleet is
        full.  (With one stepper this degenerates to "is a slot free".)"""
        best_key, best = None, None
        for i, st in enumerate(self.steppers):
            if not st.has_free_slot:
                continue
            key = (st.load, -st.deadline_slack(now), self._last_dispatch[i])
            if best_key is None or key < best_key:
                best_key, best = key, i
        return best

    def _admit_ready(self) -> None:
        """Drain arrived requests into free slots fleet-wide, one routing
        decision per request (the queue's deadline-aware pop picks WHICH
        request, ``_route`` picks WHERE); each admission reads the clock
        ONCE — the same timestamp keys the routing slack, gates the pop,
        and stamps ``on_admit``."""
        while True:
            now = self.clock.now()
            route_span = self.tracer.begin("route", "router")
            target = self._route(now)
            if target is None:
                route_span.end()
                return
            with self.tracer.span("queue_pop", "router"):
                req = self.queue.pop_ready(now)
            if req is None:
                route_span.end()
                return
            route_span.set("replica", target)
            route_span.set("rid", req.rid)
            route_span.end()
            self.steppers[target].admit(req, now)
            self._seq += 1
            self._last_dispatch[target] = self._seq

    def run(self) -> dict[int, list]:
        """Serve until the queue drains and every slot retires.  Returns the
        merged {rid: emitted tokens}; telemetry accumulates in each stepper's
        ServerStats."""
        if self._start_run():
            t0 = self.clock.now()
            for st in self.steppers:
                st.stats.started_s = t0  # later runs keep the original
                # start so summary() throughput spans all serving
        while self._pending or self.queue.pending or self.occupied:
            self._feed_arrived()
            self._admit_ready()
            busy = [st for st in self.steppers if st.occupied]
            if not busy:
                nxt = self._next_arrival()
                if nxt is None:
                    break
                with self.tracer.span("idle", "router"):
                    self.clock.wait_until(nxt)  # idle: jump to the next arrival
                continue
            self.rounds += 1
            if self.fleet is not None:
                self._process_round(busy)
                continue
            # one global round: every busy stepper dispatches (with async
            # rounds nothing waits for the card until the absorbs), the clock
            # ticks once, then every stepper absorbs and retires.  If any
            # dispatch or absorb raises, every other dispatched round is
            # aborted on the way out — no open round span, no orphaned
            # RoundInFlight.
            stepped: list = []
            try:
                for st in busy:
                    stepped.append((st, st.step()))
                # the global round costs what the deepest replica round cost
                now, qdepth = self._tick(busy)
                while stepped:
                    st, res = stepped.pop(0)
                    st.stats.on_round(st.occupied, qdepth)
                    st.absorb_round(res, now)
            except BaseException:
                for st, res in stepped:
                    st.abort_round(res)
                raise
        t1 = self.clock.now()
        for st in self.steppers:
            st.stats.finished_s = t1
        return self.results

    def _tick(self, busy) -> tuple[float, int]:
        """The clock's one tick for a global round, by the deepest busy
        replica's depth; the round's time and queue depth (recorded)."""
        self.clock.on_round(max(st.last_round_depth for st in busy))
        now = self.clock.now()
        qdepth = self.queue.depth(now)
        self._m_queue_depth.append(now, qdepth)
        self.tracer.counter("queue_depth", qdepth)
        self.tracer.counter("occupied", self.occupied)
        return now, qdepth

    def _process_round(self, busy) -> None:
        """One fleet round on a fleet of processes: the own replica
        dispatches (the mirrors take their round's depth), the clock ticks,
        the own replica reconciles, one exchange on the host brings every
        replica's result to every rank, and every busy replica absorbs it,
        in replica order.  A failure in the own replica's dispatch or
        reconcile is held until the exchange, which carries its flag: every
        rank raises in this fleet round (the failed ranks their error, the
        others a RuntimeError naming the ranks), none waits at the next."""
        fleet = self.fleet
        own = self.steppers[fleet.replica]
        bs = own.engine.cfg.bs
        for st in busy:
            if st is not own:
                st.step()
        mine, failure, res = None, None, None
        counts = own.round_counts()
        try:
            if own.occupied:
                res = own.step()
        except Exception as e:  # raised after the exchange, on every rank
            failure = e
        now, qdepth = self._tick(busy)
        try:
            if own.occupied and failure is None:
                mine = own.resolve(res)
        except Exception as e:
            failure = e
        row = pack_round(mine, own.round_counts() - counts, own.n_slots, bs, failure is not None)
        with self.tracer.span("fleet_exchange", "router"):
            rows = fleet.exchange_rows(row)
        failed = [r for r in range(len(rows)) if rows[r, 0]]
        if failed:
            if own.occupied:
                own.abort_round(None)  # close the open round span
            if failure is not None:
                raise failure
            raise RuntimeError(f"fleet round {self.rounds}: rank(s) {failed} failed in their "
                               f"replica's round; replica {fleet.replica} stops with them")
        for st in busy:
            row = rows[fleet.row_of(st.replica)]
            if not row[1]:
                raise RuntimeError(f"fleet round {self.rounds}: replica {st.replica}'s ranks did "
                                   "not step it: the ranks' fleet states diverged")
            got, delta = unpack_round(row, st.n_slots, bs)
            if st.mirror:
                st.mirror_round(got, delta)
            st.stats.on_round(st.occupied, qdepth)
            st.absorb_round(got, now)


class ContinuousBatchingRuntime(ServingRuntimeBase):
    """Drives one SpecEngine state of ``n_slots`` batch rows over a request
    queue.  ``stream(rid, new_tokens, done)`` is called once per round per
    occupied slot with that round's freshly verified tokens."""

    def __init__(self, engine, tparams, dparams, n_slots: int, *,
                 queue: RequestQueue | None = None,
                 clock=None,
                 stats: ServerStats | None = None,
                 stream: Callable[[int, list, bool], None] | None = None,
                 tracer=None,
                 metrics: MetricsRegistry | None = None,
                 scheduler: SchedulerConfig | None = None):
        self._init_admission(queue, clock, tracer, metrics)
        self.stats = stats if stats is not None else ServerStats()
        self.stepper = EngineStepper(
            engine, tparams, dparams, n_slots,
            stats=self.stats, stream=stream, results=self.results,
            tracer=self.tracer, metrics=self.metrics, scheduler=scheduler)
        self._init_fleet([self.stepper])
        self.engine, self.n_slots = engine, n_slots

    @property
    def state(self):
        return self.stepper.state

    @property
    def slots(self):
        return self.stepper.slots

"""Request queue with admission control for the continuous-batching runtime.

Arrival-ordered, with two admission gates:
  * a hard queue cap (``cap``): submissions beyond it are rejected at the
    door (counted in ``rejected``) instead of growing an unbounded backlog —
    the load-shedding half of admission control;
  * arrival-time gating: a request only becomes poppable once the serving
    clock has reached its ``arrival_s`` (replaying a recorded/Poisson trace
    behaves like live traffic).

The pop is deadline-aware (docs/scheduling.md): among ARRIVED requests,
``pop_ready`` picks by ``(priority, deadline, insertion order)`` — earliest
deadline first within a priority class, deadline-free requests last in
theirs, FIFO tie-break — so a tight-SLO arrival overtakes a best-effort
backlog.  A pure EDF pop can starve deadline-free work behind a steady
deadlined stream, so ``starvation_s`` bounds it: once the oldest arrived
request has waited that long, it pops next regardless of everyone else's
deadlines.  With no deadlines and no priorities the pop degenerates to
exact FIFO (the pre-scheduling behavior).

Internally the queue is an arrived list plus a future deque: ``_ready``
(requests whose arrival time is at or before the highest ``now`` seen so
far, in insertion order) and ``_future`` (not yet arrived).  Because
submissions are arrival-ordered, every ``_future`` entry arrives after
every ``_ready`` entry, so ``depth()`` is just ``len(_ready)`` — O(1) for
the monotonic clocks the runtimes use (each request crosses the boundary
exactly once) — and the EDF scan touches only the arrived backlog.

A copy of ``repro.serving.queue``,
framework-neutral: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus per-request decode limits and SLO.

    ``deadline_s`` is an absolute point on the serving timeline (same clock
    as ``arrival_s``) by which the request should FINISH; None means
    best-effort.  ``priority`` orders pops before deadlines do — lower is
    more urgent (0 is the default class) — so an operator can pin
    interactive traffic ahead of batch traffic outright."""

    rid: int
    prompt: np.ndarray  # i32[P]
    arrival_s: float = 0.0
    max_new: int | None = None  # None: inherit the engine's max_new
    eos_id: int | None = None  # None: inherit the engine's eos_id; -1: never stop
    deadline_s: float | None = None  # absolute finish deadline; None: best-effort
    priority: int = 0  # lower pops first; ties fall through to EDF

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new is not None and self.max_new <= 0:
            raise ValueError(f"request {self.rid}: max_new must be positive")
        if self.deadline_s is not None and self.deadline_s < self.arrival_s:
            raise ValueError(
                f"request {self.rid}: deadline_s {self.deadline_s} precedes "
                f"arrival_s {self.arrival_s}")

    @property
    def edf_deadline(self) -> float:
        """The EDF sort key: best-effort requests order after any deadline."""
        return self.deadline_s if self.deadline_s is not None else float("inf")


class RequestQueue:
    def __init__(self, cap: int = 64, starvation_s: float | None = None):
        if starvation_s is not None and starvation_s <= 0:
            raise ValueError(f"starvation_s must be positive, got {starvation_s}")
        self.cap = cap
        # EDF starvation bound: once the oldest arrived request has waited
        # this long, it wins the pop regardless of deadlines (None: pure EDF)
        self.starvation_s = starvation_s
        self._ready: list[Request] = []  # arrived, in insertion (FIFO) order
        self._future: collections.deque[Request] = collections.deque()
        self.submitted = 0
        self.rejected = 0
        self._last_arrival = float("-inf")
        self._now_w = float("-inf")  # arrival watermark: max ``now`` seen

    def _advance(self, now: float) -> None:
        """Migrate newly arrived requests across the ready/future boundary
        (amortized O(1): each request crosses once under a monotonic clock)."""
        if now > self._now_w:
            self._now_w = now
        while self._future and self._future[0].arrival_s <= now:
            self._ready.append(self._future.popleft())

    def reject(self, req: Request) -> bool:
        """Count a request rejected by an external admission gate (e.g. the
        runtime's prompt-length check), keeping all accounting in one place."""
        self.submitted += 1
        self.rejected += 1
        return False

    def submit(self, req: Request) -> bool:
        """Admission control: returns False (and counts the shed) on a full
        queue.  FUTURE submissions must come in arrival order (trace replay);
        an out-of-order future submission raises without touching the
        counters, so ``submitted == queued + rejected`` always holds.  An
        already-arrived submission (``arrival_s`` at or behind the watermark)
        is always orderable — it queues behind everything already here, in
        submission order — so live submits racing a trace feed cannot poison
        the queue (the ready/future split stays sorted either way)."""
        if req.arrival_s > self._now_w and req.arrival_s < self._last_arrival:
            raise ValueError("future submissions must be ordered by arrival_s")
        self.submitted += 1
        if len(self._ready) + len(self._future) >= self.cap:
            self.rejected += 1
            return False
        self._last_arrival = max(self._last_arrival, req.arrival_s)
        if req.arrival_s <= self._now_w:
            self._ready.append(req)
        else:
            self._future.append(req)
        return True

    def pop_ready(self, now: float) -> Request | None:
        """Deadline-aware priority pop over the ARRIVED backlog, or None.

        Selection key: ``(priority, deadline, insertion order)`` — EDF
        within a priority class, best-effort (deadline-free) requests last
        in theirs, FIFO tie-break — which is exact FIFO when nothing
        carries a deadline or priority.  Starvation bound: with
        ``starvation_s`` set, an oldest-arrived request that has waited at
        least that long pops first unconditionally, so a steady deadlined
        stream cannot park best-effort work forever."""
        self._advance(now)
        # the watermark may sit ahead of a non-monotonic probe: re-check each
        # entry's arrival against THIS ``now`` so gating stays exact
        arrived = [i for i, r in enumerate(self._ready) if r.arrival_s <= now]
        if not arrived:
            return None
        oldest = arrived[0]  # insertion order == arrival order for traces
        if (self.starvation_s is not None
                and now - self._ready[oldest].arrival_s >= self.starvation_s):
            return self._ready.pop(oldest)
        best = min(arrived,
                   key=lambda i: (self._ready[i].priority,
                                  self._ready[i].edf_deadline, i))
        return self._ready.pop(best)

    def next_arrival(self) -> float | None:
        """Arrival time of the head request (None when empty)."""
        if self._ready:
            return self._ready[0].arrival_s
        return self._future[0].arrival_s if self._future else None

    def depth(self, now: float) -> int:
        """Requests that have arrived and are waiting for a slot.  O(1) for
        monotonic ``now``; a probe behind the watermark rescans exactly."""
        if now < self._now_w:
            return sum(1 for r in self._ready if r.arrival_s <= now)
        self._advance(now)
        return len(self._ready)

    @property
    def pending(self) -> int:
        """All waiting requests, including not-yet-arrived trace entries."""
        return len(self._ready) + len(self._future)

    def __len__(self) -> int:
        return len(self._ready) + len(self._future)

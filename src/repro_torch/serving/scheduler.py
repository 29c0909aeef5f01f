"""SLO-aware scheduling: per-slot adaptive draft depth for the serving fleet.

The engine's draft depth ``d`` (tree expansions per round) was a single
global knob, but acceptance rates vary wildly per request — the open
adaptation problem called out by the speculative-decoding surveys and solved
on-the-fly by SWIFT (arXiv:2410.06916).  A request whose measured acceptance
is ~1 token/round wastes most of a depth-4 tree (the unaccepted levels are
pure draft latency); a request accepting ~4 tokens/round is starved by a
depth-1 tree (extra verification rounds for the same stream).  This module
closes the loop:

``AdaptiveDepthController``
    One per ``EngineStepper``.  Each slot carries an EMA of its measured
    per-round acceptance (fed from the same observations as the
    ``serving_accept_depth`` histogram; a fresh slot is seeded from that
    histogram's running mean, so a warm replica starts new requests at the
    fleet's observed operating point).  The EMA maps to a depth *bucket* —
    ``SchedulerConfig.depth_buckets``, e.g. ``(1, 2, 3, 4)`` — and the
    round's effective depth is the max bucket over occupied slots (depth is
    a round-level property of the shared tree batch; extra depth never
    changes a neighbor's tokens, only spends draft time).  Bucketing is the
    recompile bound: depth enters ``EngineSession.step`` /
    ``draft_next_tree`` as a host-side Python loop count over the one jitted
    ``_expand`` program, so the jit cache is *independent* of how depths
    vary round to round (tests assert the compile count stays flat across
    every bucket).

Correctness contract: adaptation changes *when* tokens verify, never
*which* tokens a row emits — greedy verification pins each row's stream to
target-only greedy decoding at any depth, so any per-slot depth schedule is
byte-identical to solo ``generate()`` (tests/test_scheduler.py).

Deadline semantics (the other half of SLO-aware scheduling) live in
``repro_torch.serving.queue`` (EDF pop with a starvation bound) and
``repro_torch.serving.runtime`` (deadline-slack-aware routing); the SLO metrics
land in ``repro_torch.serving.stats``.  See docs/scheduling.md.

A copy of ``repro.serving.scheduler``,
framework-neutral: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Adaptive-depth policy knobs.

    ``depth_buckets``
        The admissible round depths, ascending.  Each bucket is one
        host-side loop count over the shared jitted expand program — the
        bucket count bounds scheduling-induced recompiles at zero new
        traces (the program is depth-independent), and bounds the distinct
        round shapes the fleet can emit.
    ``thresholds``
        Ascending acceptance-EMA cut points, one fewer than the buckets:
        bucket ``i`` is chosen while ``thresholds[i-1] <= ema <
        thresholds[i]``.  None derives ``(1.0, 2.0, ...)`` — draft roughly
        as deep as the tokens/round the slot actually sustains, the SWIFT
        heuristic (accepted tokens consume tree depth; drafting much past
        measured acceptance is latency with no expected yield).
    ``ema_alpha``
        Weight of the newest round in the per-slot acceptance EMA.
    ``seed_acceptance``
        Explicit EMA seed for fresh slots.  None: seed from the replica's
        ``serving_accept_depth`` histogram mean when it has observations,
        else fall back to the engine's configured global depth.
    """

    depth_buckets: tuple[int, ...] = (1, 2, 3, 4)
    thresholds: tuple[float, ...] | None = None
    ema_alpha: float = 0.25
    seed_acceptance: float | None = None

    def __post_init__(self):
        b = tuple(int(d) for d in self.depth_buckets)
        if not b or any(d < 1 for d in b) or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(
                f"depth_buckets must be ascending positive ints, got {self.depth_buckets}")
        object.__setattr__(self, "depth_buckets", b)
        if self.thresholds is not None:
            t = tuple(float(x) for x in self.thresholds)
            if len(t) != len(b) - 1 or any(y <= x for x, y in zip(t, t[1:])):
                raise ValueError(
                    f"need {len(b) - 1} ascending thresholds for {len(b)} buckets, "
                    f"got {self.thresholds}")
            object.__setattr__(self, "thresholds", t)
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError(f"ema_alpha must be in (0, 1], got {self.ema_alpha}")

    @property
    def cut_points(self) -> tuple[float, ...]:
        """The resolved acceptance-EMA thresholds between buckets."""
        if self.thresholds is not None:
            return self.thresholds
        return tuple(float(i) for i in range(1, len(self.depth_buckets)))

    def bucket_for(self, ema: float) -> int:
        """Map an acceptance EMA to a draft depth (the bucket whose band
        contains it)."""
        return self.depth_buckets[bisect.bisect_right(self.cut_points, ema)]

    def clamp(self, depth: int) -> int:
        """The nearest admissible bucket to ``depth`` (ties go shallow —
        the cheaper round)."""
        return min(self.depth_buckets, key=lambda b: (abs(b - depth), b))


class AdaptiveDepthController:
    """Per-slot acceptance EMAs -> the round's effective draft depth.

    Owned by one ``EngineStepper``; everything here is host arithmetic on
    already-transferred per-round ints, so it adds nothing to the hot
    round's device or sync schedule.
    """

    def __init__(self, cfg: SchedulerConfig, n_slots: int, *,
                 default_depth: int, seed_hist=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.default_depth = cfg.clamp(int(default_depth))
        # the replica's serving_accept_depth Histogram (repro_torch.obs.metrics):
        # its running mean seeds fresh slots at the observed operating point
        self._seed_hist = seed_hist
        self._ema: list[float | None] = [None] * n_slots

    # ---- per-slot lifecycle (driven by the stepper) ----------------------
    def seed_slot(self, slot: int) -> None:
        """A request was admitted into ``slot``: start its EMA from the best
        prior available (explicit seed > histogram mean > no prior, which
        falls back to the engine's default depth until measurements land)."""
        if self.cfg.seed_acceptance is not None:
            self._ema[slot] = float(self.cfg.seed_acceptance)
        elif self._seed_hist is not None and getattr(self._seed_hist, "count", 0):
            self._ema[slot] = float(self._seed_hist.mean)
        else:
            self._ema[slot] = None

    def clear_slot(self, slot: int) -> None:
        """The slot retired; its acceptance history must not leak into the
        next occupant (they are different requests)."""
        self._ema[slot] = None

    def observe(self, slot: int, n_accepted: int) -> None:
        """Fold one round's measured acceptance for ``slot`` into its EMA."""
        a = self._ema[slot]
        x = float(n_accepted)
        self._ema[slot] = x if a is None else (1.0 - self.cfg.ema_alpha) * a \
            + self.cfg.ema_alpha * x

    # ---- read side -------------------------------------------------------
    def slot_ema(self, slot: int) -> float | None:
        return self._ema[slot]

    def slot_depth(self, slot: int) -> int:
        """The depth bucket this slot's EMA currently selects."""
        a = self._ema[slot]
        return self.default_depth if a is None else self.cfg.bucket_for(a)

    def round_depth(self, occupied) -> int:
        """The round's effective draft depth: the max bucket over occupied
        slots.  Depth is a property of the whole batched tree round, and max
        never under-serves a slot — a low-acceptance neighbor riding a
        deeper tree spends draft time but emits identical tokens (the
        byte-identity contract), while a high-acceptance slot in a too-
        shallow tree pays real extra verification rounds."""
        depths = [self.slot_depth(i) for i, occ in enumerate(occupied) if occ]
        return max(depths) if depths else self.default_depth


def deadline_slack(active, now: float) -> float:
    """Tightest remaining deadline slack (seconds) across an iterable of
    occupied-slot records carrying ``req.deadline_s`` (None entries and
    deadline-free requests are skipped); +inf when nothing is deadlined.
    The router subtracts this pressure signal when breaking occupancy ties,
    steering new admissions away from replicas that must finish something
    soon."""
    slacks = [a.req.deadline_s - now for a in active
              if a is not None and a.req.deadline_s is not None]
    return min(slacks) if slacks else math.inf

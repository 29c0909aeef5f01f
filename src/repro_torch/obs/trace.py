"""Phase tracer — ring-buffered spans with monotonic timestamps.

The serving stack's latency argument (draft expansion vs. target
verification vs. KV reconciliation inside each round — the paper's
decomposition) needs *where-did-the-milliseconds-go* evidence, not just
end-of-run aggregates.  ``Tracer`` records host-side phase spans:

  * ``begin(name, track)`` / ``Span.end()`` — explicit span lifetime (used
    where begin and end live in different methods, e.g. a round span opened
    by ``EngineStepper.step`` and closed by ``absorb_round``);
  * ``span(name, track)`` — the same span as a context manager;
  * ``instant(name)`` / ``counter(name, value)`` — point events and
    time-series counters (queue depth, occupancy).

Disabled-path contract: a disabled tracer is free.  ``begin``/``span``
return the cached ``NOOP_SPAN`` singleton before touching the clock, so the
per-round hot path allocates nothing and pays two attribute loads + a
branch (tests/test_obs.py asserts zero traced allocation).  ``NULL_TRACER``
is the shared inert default every runtime falls back to.

Storage is a bounded ``deque`` per event kind (oldest spans drop first,
counted in ``dropped``), so a long-running server cannot grow without
bound.  Export: ``to_chrome()`` emits the Chrome/Perfetto ``traceEvents``
JSON (open in ``ui.perfetto.dev`` or ``chrome://tracing``); ``write(path)``
picks Chrome JSON or span-per-line JSONL from the file extension.

Timestamps are ``repro_torch.obs.clock.monotonic()`` (fractional seconds)
relative to tracer construction; the clock is injectable for deterministic
tests.
"""

from __future__ import annotations

import collections
import json

from repro_torch.obs.clock import monotonic


class _NoopSpan:
    """Inert span: the single cached object every disabled call returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass

    def set(self, key, value) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One finished or in-flight phase span on one track."""

    __slots__ = ("_tracer", "name", "track", "t0", "t1", "args")

    def __init__(self, tracer: "Tracer", name: str, track: str, t0: float, args):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.t0 = t0
        self.t1 = None
        self.args = args

    @property
    def dur(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def set(self, key, value) -> None:
        """Attach one arg after creation (e.g. a routing decision made
        mid-span)."""
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def end(self) -> None:
        if self.t1 is None:
            self.t1 = self._tracer._now()
            self._tracer._finish(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    def __init__(self, capacity: int = 1 << 16, enabled: bool = True, clock=None):
        self.enabled = enabled
        self.capacity = capacity
        self.dropped = 0
        self._clock = clock if clock is not None else monotonic
        self._epoch = self._clock()
        self._spans: collections.deque[Span] = collections.deque(maxlen=capacity)
        self._instants: collections.deque = collections.deque(maxlen=capacity)
        self._counters: collections.deque = collections.deque(maxlen=capacity)
        self._tracks: dict[str, int] = {}

    # ---- recording -------------------------------------------------------
    def _now(self) -> float:
        return self._clock() - self._epoch

    def _finish(self, span: Span) -> None:
        if len(self._spans) == self.capacity:
            self.dropped += 1
        self._spans.append(span)

    def begin(self, name: str, track: str = "main", args=None):
        """Open a span; close it with ``.end()`` (or use it as a context
        manager).  Disabled: returns the cached no-op singleton."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, track, self._now(), args)

    # a span used inline reads better as ``with tracer.span(...):``
    span = begin

    def instant(self, name: str, track: str = "main", args=None) -> None:
        if not self.enabled:
            return
        if len(self._instants) == self.capacity:
            self.dropped += 1
        self._instants.append((name, track, self._now(), args))

    def counter(self, name: str, value, track: str = "counters") -> None:
        """One sample of a time-series counter (queue depth, occupancy)."""
        if not self.enabled:
            return
        if len(self._counters) == self.capacity:
            self.dropped += 1
        self._counters.append((name, track, self._now(), value))

    # ---- reading ---------------------------------------------------------
    def spans(self, name: str | None = None) -> list[Span]:
        """Finished spans in completion order (optionally one name)."""
        if name is None:
            return list(self._spans)
        return [s for s in self._spans if s.name == name]

    def counters(self, name: str | None = None) -> list:
        if name is None:
            return list(self._counters)
        return [c for c in self._counters if c[0] == name]

    # ---- export ----------------------------------------------------------
    def _tid(self, track: str) -> int:
        return self._tracks.setdefault(track, len(self._tracks))

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``traceEvents`` JSON (timestamps in µs)."""
        events = []
        for s in self._spans:
            ev = {"name": s.name, "cat": "phase", "ph": "X", "pid": 0,
                  "tid": self._tid(s.track),
                  "ts": s.t0 * 1e6, "dur": s.dur * 1e6}
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        for name, track, t, args in self._instants:
            ev = {"name": name, "cat": "event", "ph": "i", "s": "t",
                  "pid": 0, "tid": self._tid(track), "ts": t * 1e6}
            if args:
                ev["args"] = args
            events.append(ev)
        for name, track, t, value in self._counters:
            events.append({"name": name, "cat": "counter", "ph": "C", "pid": 0,
                           "tid": self._tid(track), "ts": t * 1e6,
                           "args": {name: value}})
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}}
                for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def to_jsonl(self) -> str:
        """One finished span per line: name, track, t0/t1/dur (seconds)."""
        lines = []
        for s in self._spans:
            rec = {"name": s.name, "track": s.track,
                   "t0": s.t0, "t1": s.t1, "dur": s.dur}
            if s.args:
                rec["args"] = s.args
            lines.append(json.dumps(rec))
        return "\n".join(lines) + ("\n" if lines else "")

    def write(self, path: str) -> str:
        """Dump the trace: ``.jsonl`` → span-per-line, anything else →
        Chrome ``traceEvents`` JSON."""
        with open(path, "w") as f:
            if path.endswith(".jsonl"):
                f.write(self.to_jsonl())
            else:
                json.dump(self.to_chrome(), f)
        return path


# the shared inert default: every instrument point falls back to this, so
# an un-instrumented run pays only the disabled-path branch
NULL_TRACER = Tracer(capacity=0, enabled=False)

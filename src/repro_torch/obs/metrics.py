"""MetricsRegistry — counters, gauges, histograms, and bounded sample series
with per-replica labels.

The registry is the fleet's numeric state (the tracer is its timeline):
per-replica round counters, the accepted-depth distribution the adaptive-
depth scheduler (ROADMAP #2) will read, queue-depth-over-time samples, TTFT
histograms, KV-budget truncation counts.  Handles are get-or-create keyed by
``(name, labels)`` — ask twice, get the same object — so instrument points
cache a handle once and touch only that object on the hot path.

Export: ``snapshot()`` is the structured dict (what ``--metrics-out``
writes); ``to_prometheus()`` is the standard text exposition format
(cumulative ``_bucket``/``_sum``/``_count`` lines for histograms, last
value for series).

A copy of ``repro.obs.metrics``,
framework-neutral: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import collections
import json


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds, with
    an implicit +Inf bucket; ``counts[i]`` is the NON-cumulative count of
    observations <= buckets[i] (cumulation happens at export)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        b = tuple(float(x) for x in buckets)
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"buckets must be non-empty ascending, got {buckets}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.sum += x
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if x <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Series:
    """Bounded (timestamp, value) samples — 'X over time' (queue depth,
    occupancy) where a histogram would lose the trajectory."""

    __slots__ = ("samples", "dropped")

    def __init__(self, maxlen: int = 4096):
        self.samples: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0

    def append(self, t: float, value: float) -> None:
        if len(self.samples) == self.samples.maxlen:
            self.dropped += 1
        self.samples.append((t, value))

    @property
    def last(self) -> float | None:
        return self.samples[-1][1] if self.samples else None

    def values(self) -> list[float]:
        return [v for _, v in self.samples]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else ""


class MetricsRegistry:
    def __init__(self):
        # kind -> name -> label_key -> metric object
        self._m: dict[str, dict[str, dict[tuple, object]]] = {
            "counter": {}, "gauge": {}, "histogram": {}, "series": {},
        }

    def _get(self, kind: str, name: str, labels: dict, make):
        fam = self._m[kind].setdefault(name, {})
        key = _label_key(labels)
        got = fam.get(key)
        if got is None:
            got = fam[key] = make()
        return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                                            0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
                  **labels) -> Histogram:
        """Get-or-create; ``buckets`` only applies on first creation (the
        family keeps its original bucket layout)."""
        return self._get("histogram", name, labels, lambda: Histogram(buckets))

    def series(self, name: str, maxlen: int = 4096, **labels) -> Series:
        return self._get("series", name, labels, lambda: Series(maxlen))

    def histogram_family(self, name: str) -> list[tuple[dict, Histogram]]:
        """Every (labels, histogram) pair registered under ``name`` — e.g.
        the per-replica ``serving_accept_depth`` family, for fleet-level
        merging with ``merge_histograms``.  Read-only: does not create."""
        fam = self._m["histogram"].get(name, {})
        return [(dict(key), h) for key, h in sorted(fam.items())]

    def series_family(self, name: str) -> list[tuple[dict, Series]]:
        """Every (labels, series) pair registered under ``name`` — e.g. the
        per-replica ``serving_round_depth`` family.  Read-only: does not
        create."""
        fam = self._m["series"].get(name, {})
        return [(dict(key), s) for key, s in sorted(fam.items())]

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured dump of every metric (the ``--metrics-out`` payload)."""
        out: dict = {"counters": [], "gauges": [], "histograms": [], "series": []}
        for name, fam in sorted(self._m["counter"].items()):
            for key, c in sorted(fam.items()):
                out["counters"].append(
                    {"name": name, "labels": dict(key), "value": c.value})
        for name, fam in sorted(self._m["gauge"].items()):
            for key, g in sorted(fam.items()):
                out["gauges"].append(
                    {"name": name, "labels": dict(key), "value": g.value})
        for name, fam in sorted(self._m["histogram"].items()):
            for key, h in sorted(fam.items()):
                out["histograms"].append({
                    "name": name, "labels": dict(key),
                    "buckets": list(h.buckets), "counts": list(h.counts),
                    "sum": h.sum, "count": h.count, "mean": h.mean,
                })
        for name, fam in sorted(self._m["series"].items()):
            for key, s in sorted(fam.items()):
                out["series"].append({
                    "name": name, "labels": dict(key),
                    "samples": [[t, v] for t, v in s.samples],
                    "dropped": s.dropped,
                })
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (series render as last-value gauges)."""
        lines: list[str] = []
        for name, fam in sorted(self._m["counter"].items()):
            lines.append(f"# TYPE {name} counter")
            for key, c in sorted(fam.items()):
                lines.append(f"{name}{_label_str(key)} {_fmt(c.value)}")
        for name, fam in sorted(self._m["gauge"].items()):
            lines.append(f"# TYPE {name} gauge")
            for key, g in sorted(fam.items()):
                lines.append(f"{name}{_label_str(key)} {_fmt(g.value)}")
        for name, fam in sorted(self._m["histogram"].items()):
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(fam.items()):
                cum = 0
                for ub, c in zip(h.buckets, h.counts):
                    cum += c
                    lk = _label_key({**dict(key), "le": _fmt(ub)})
                    lines.append(f"{name}_bucket{_label_str(lk)} {cum}")
                lk = _label_key({**dict(key), "le": "+Inf"})
                lines.append(f"{name}_bucket{_label_str(lk)} {h.count}")
                lines.append(f"{name}_sum{_label_str(key)} {_fmt(h.sum)}")
                lines.append(f"{name}_count{_label_str(key)} {h.count}")
        for name, fam in sorted(self._m["series"].items()):
            lines.append(f"# TYPE {name} gauge")
            for key, s in sorted(fam.items()):
                if s.samples:
                    lines.append(f"{name}{_label_str(key)} {_fmt(s.last)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write(self, path: str, extra: dict | None = None) -> str:
        """Write the snapshot as JSON (``.prom`` → Prometheus text).  ``extra``
        merges additional top-level sections (e.g. a phase breakdown)."""
        with open(path, "w") as f:
            if path.endswith(".prom"):
                f.write(self.to_prometheus())
            else:
                payload = self.snapshot()
                if extra:
                    payload.update(extra)
                json.dump(payload, f, indent=1)
        return path


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def merge_histograms(hists) -> Histogram:
    """Merge histograms that may have DIFFERENT bucket layouts: the result's
    buckets are the sorted union of every source's upper bounds, each source
    bucket's count lands at the union bucket with the same upper bound, and
    +Inf counts stay in +Inf.  Lossless in the Prometheus sense — an
    observation counted "<= ub" at the source is still counted "<= ub" in
    the merge (replicas running different draft depths have different
    ``serving_accept_depth`` edges; summing counts positionally would
    misfile them)."""
    hists = list(hists)
    if not hists:
        raise ValueError("need at least one histogram to merge")
    edges = sorted({ub for h in hists for ub in h.buckets})
    out = Histogram(edges)
    pos = {ub: i for i, ub in enumerate(edges)}
    for h in hists:
        for ub, c in zip(h.buckets, h.counts):
            out.counts[pos[ub]] += c
        out.counts[-1] += h.counts[-1]
        out.sum += h.sum
        out.count += h.count
    return out

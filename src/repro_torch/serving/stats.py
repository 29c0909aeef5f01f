"""ServerStats — telemetry for the continuous-batching runtime.

Per-request records (TTFT, decode tok/s, acceptance rate, slot + round
lifetime) plus per-round engine samples (slot occupancy, queue depth).  The
round-interval columns in ``report()`` are the direct evidence of continuous
batching: requests admitted mid-flight show overlapping [admit, finish)
round ranges.

A copy of ``repro.serving.stats``,
framework-neutral: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    rid: int
    slot: int = -1
    replica: int = 0  # which engine replica served the request (sharded runtime)
    arrival_s: float = 0.0
    admitted_s: float = 0.0
    first_token_s: float | None = None
    finish_s: float | None = None
    admit_round: int = -1
    finish_round: int = -1
    n_tokens: int = 0
    n_rounds: int = 0
    n_accepted: int = 0
    truncated: bool = False  # cut off by the KV budget, not EOS/max_new
    deadline_s: float | None = None  # absolute finish deadline; None: best-effort
    priority: int = 0

    @property
    def ttft_s(self) -> float | None:
        """Time to first token, measured from arrival (includes queueing)."""
        return None if self.first_token_s is None else self.first_token_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def tok_per_s(self) -> float | None:
        """Decode throughput from admission to finish (excludes queueing)."""
        if self.finish_s is None or self.finish_s <= self.admitted_s:
            return None
        return self.n_tokens / (self.finish_s - self.admitted_s)

    @property
    def acceptance(self) -> float:
        """Accepted draft tokens per verification round.  A record with no
        rounds has no measurable acceptance: nan, per the repo's nan-marking
        convention — a floored 0.0 here would silently read as 'this request
        accepted nothing'."""
        return self.n_accepted / self.n_rounds if self.n_rounds else float("nan")

    @property
    def compression_ratio(self) -> float:
        """Emitted tokens per target inference (the paper's metric); nan
        before any round has run."""
        return self.n_tokens / self.n_rounds if self.n_rounds else float("nan")

    @property
    def slack_s(self) -> float | None:
        """Deadline slack at finish: positive met the SLO by that margin,
        negative missed by it.  None while unfinished or best-effort."""
        if self.deadline_s is None or self.finish_s is None:
            return None
        return self.deadline_s - self.finish_s

    @property
    def met_deadline(self) -> bool | None:
        """Whether the request finished by its deadline (None: best-effort
        or still in flight)."""
        s = self.slack_s
        return None if s is None else s >= 0.0


def percentile(xs, p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p)) if len(xs) else float("nan")


def _mean_acceptance(recs) -> float:
    """Rounds-weighted mean acceptance: total accepted over total rounds.
    An unweighted mean of per-request ratios would let a 1-round request
    count the same as a 100-round request (the bias the rounds-weighted
    fleet occupancy avoids too).  Weighting by rounds also naturally excludes zero-round
    records (weight 0) instead of propagating their nan acceptance.  0.0
    with no records at all (matching ``mean_occupancy``); nan when records
    exist but no round ever ran (no measurement, not zero acceptance)."""
    if not recs:
        return 0.0
    rounds = sum(r.n_rounds for r in recs)
    if not rounds:
        return float("nan")
    return sum(r.n_accepted for r in recs) / rounds


def _slo_fields(recs) -> dict:
    """SLO attainment + slack percentiles over finished records.  Only
    deadlined requests enter: attainment over best-effort traffic is not a
    meaningful SLO.  nan-marked when nothing carried a deadline."""
    slacks = [r.slack_s for r in recs if r.slack_s is not None]
    met = sum(1 for s in slacks if s >= 0.0)
    return {
        "n_deadlined": len(slacks),
        "slo_attainment": met / len(slacks) if slacks else float("nan"),
        "slack_p50_s": percentile(slacks, 50),
        "slack_p10_s": percentile(slacks, 10),  # near-worst-case margin
    }


def _fmt_or_dash(v: float | None, spec: str) -> str:
    """Render a telemetry cell: ``-`` for missing (None/nan) values."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return "-"
    return format(v, spec)


class ServerStats:
    def __init__(self):
        self.records: dict[int, RequestRecord] = {}
        self.rounds = 0
        self.occupancy_samples: list[int] = []
        self.queue_depth_samples: list[int] = []
        self.started_s: float = 0.0
        self.finished_s: float = 0.0

    # ---- runtime hooks ---------------------------------------------------
    def on_admit(self, rid: int, slot: int, arrival_s: float, now: float,
                 replica: int = 0, deadline_s: float | None = None,
                 priority: int = 0) -> None:
        self.records[rid] = RequestRecord(
            rid=rid, slot=slot, replica=replica, arrival_s=arrival_s,
            admitted_s=now, admit_round=self.rounds,
            deadline_s=deadline_s, priority=priority,
        )

    def on_round(self, occupied: int, queue_depth: int) -> None:
        self.rounds += 1
        self.occupancy_samples.append(occupied)
        self.queue_depth_samples.append(queue_depth)

    def on_tokens(self, rid: int, n_new: int, n_accepted: int, now: float) -> None:
        r = self.records[rid]
        r.n_rounds += 1
        r.n_accepted += n_accepted
        if n_new > 0:
            if r.first_token_s is None:
                r.first_token_s = now
            r.n_tokens += n_new

    def on_finish(self, rid: int, now: float, truncated: bool = False) -> None:
        r = self.records[rid]
        r.finish_s = now
        r.finish_round = self.rounds
        r.truncated = truncated

    # ---- aggregates ------------------------------------------------------
    def finished_records(self) -> list[RequestRecord]:
        return [r for r in self.records.values() if r.finish_s is not None]

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy_samples)) if self.occupancy_samples else 0.0

    def summary(self) -> dict:
        recs = self.finished_records()
        ttfts = [r.ttft_s for r in recs if r.ttft_s is not None]
        total_tokens = sum(r.n_tokens for r in recs)
        # started_s/finished_s default to 0.0; a window that was never
        # stamped (or never advanced) has no meaningful width, so report nan
        # instead of a 1e-9-floor throughput in the trillions
        wall = self.finished_s - self.started_s
        return {
            "n_finished": len(recs),
            "total_tokens": total_tokens,
            "throughput_tok_s": total_tokens / wall if wall > 0 else float("nan"),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "mean_occupancy": self.mean_occupancy,
            "mean_acceptance": _mean_acceptance(recs),
            "rounds": self.rounds,
            **_slo_fields(recs),
        }

    def report(self) -> str:
        lines = ["rid slot  arrive  admit  rounds[admit,fin)   ttft_s  tok/s  accept  ntok  slack_s"]
        for r in sorted(self.records.values(), key=lambda r: r.rid):
            lines.append(
                f"{r.rid:3d} {r.slot:4d} {r.arrival_s:7.3f} {r.admitted_s:6.3f} "
                f"   [{r.admit_round:4d},{r.finish_round:4d})  "
                f"{_fmt_or_dash(r.ttft_s, '7.3f'):>7} {_fmt_or_dash(r.tok_per_s, '6.1f'):>6} "
                f"{_fmt_or_dash(r.acceptance, '7.2f'):>7} {r.n_tokens:5d} "
                f"{_fmt_or_dash(r.slack_s, '+8.3f'):>8}"
                + ("  TRUNCATED(kv-budget)" if r.truncated else "")
                + ("  LATE" if r.met_deadline is False else "")
            )
        s = self.summary()
        lines.append(
            f"aggregate: {s['n_finished']} finished, "
            f"{_fmt_or_dash(s['throughput_tok_s'], '.1f')} tok/s, "
            f"TTFT p50={_fmt_or_dash(s['ttft_p50_s'], '.3f')}s "
            f"p99={_fmt_or_dash(s['ttft_p99_s'], '.3f')}s, "
            f"occupancy {s['mean_occupancy']:.2f}, "
            f"acceptance {_fmt_or_dash(s['mean_acceptance'], '.2f')}"
            + (f", SLO {s['slo_attainment']:.0%} of {s['n_deadlined']} "
               f"(slack p50 {s['slack_p50_s']:+.3f}s p10 {s['slack_p10_s']:+.3f}s)"
               if s["n_deadlined"] else "")
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# multi-replica aggregation (sharded runtime: one ServerStats per replica)
# ---------------------------------------------------------------------------


def merge_summary(per_replica: list["ServerStats"], accept_hists=None) -> dict:
    """Fold N per-replica ServerStats into one fleet summary: global TTFT
    percentiles and throughput (tokens over the union of serving windows),
    rounds-weighted fleet acceptance, SLO attainment + slack percentiles
    over the fleet's deadlined requests, plus the per-replica occupancy/
    round breakdown that shows whether the router kept the fleet balanced.

    ``accept_hists`` (optional): the per-replica ``serving_accept_depth``
    Histogram objects.  Replicas may run different draft depths and so have
    different bucket edges — the merge unions the edges rather than summing
    counts positionally — and the result lands in ``accept_depth_mean`` /
    ``accept_depth_hist``."""
    recs = [r for st in per_replica for r in st.finished_records()]
    ttfts = [r.ttft_s for r in recs if r.ttft_s is not None]
    total_tokens = sum(r.n_tokens for r in recs)
    started = min((st.started_s for st in per_replica), default=0.0)
    finished = max((st.finished_s for st in per_replica), default=0.0)
    wall = finished - started
    # fleet occupancy weighted by each replica's round count: a replica that
    # sat idle (few rounds) must not drag the mean below what the busy
    # replicas actually sustained
    rounds = np.asarray([st.rounds for st in per_replica], np.float64)
    occs = np.asarray([st.mean_occupancy for st in per_replica], np.float64)
    extra: dict = {}
    if accept_hists:
        from repro_torch.obs.metrics import merge_histograms

        merged = merge_histograms(accept_hists)
        extra["accept_depth_mean"] = merged.mean
        extra["accept_depth_hist"] = {
            "buckets": list(merged.buckets), "counts": list(merged.counts),
            "sum": merged.sum, "count": merged.count,
        }
    return {
        **extra,
        "n_replicas": len(per_replica),
        "n_finished": len(recs),
        "total_tokens": total_tokens,
        "throughput_tok_s": total_tokens / wall if wall > 0 else float("nan"),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p99_s": percentile(ttfts, 99),
        "mean_occupancy": (
            float((occs * rounds).sum() / rounds.sum()) if rounds.sum() else 0.0
        ),
        "per_replica_occupancy": [st.mean_occupancy for st in per_replica],
        "per_replica_finished": [len(st.finished_records()) for st in per_replica],
        "per_replica_rounds": [st.rounds for st in per_replica],
        "mean_acceptance": _mean_acceptance(recs),
        **_slo_fields(recs),
    }


def fleet_report(per_replica: list["ServerStats"]) -> str:
    """Human-readable fleet report: every request row (tagged with the
    replica that served it) in rid order, then per-replica occupancy, then
    the merged aggregate line."""
    lines = ["rid rep slot  arrive  admit  rounds[admit,fin)   ttft_s  tok/s  accept  ntok  slack_s"]
    allrecs = [r for st in per_replica for r in st.records.values()]
    for r in sorted(allrecs, key=lambda r: r.rid):
        lines.append(
            f"{r.rid:3d} {r.replica:3d} {r.slot:4d} {r.arrival_s:7.3f} {r.admitted_s:6.3f} "
            f"   [{r.admit_round:4d},{r.finish_round:4d})  "
            f"{_fmt_or_dash(r.ttft_s, '7.3f'):>7} {_fmt_or_dash(r.tok_per_s, '6.1f'):>6} "
            f"{_fmt_or_dash(r.acceptance, '7.2f'):>7} {r.n_tokens:5d} "
            f"{_fmt_or_dash(r.slack_s, '+8.3f'):>8}"
            + ("  TRUNCATED(kv-budget)" if r.truncated else "")
            + ("  LATE" if r.met_deadline is False else "")
        )
    s = merge_summary(per_replica)
    for i, st in enumerate(per_replica):
        lines.append(
            f"replica {i}: {len(st.finished_records())} finished over {st.rounds} rounds, "
            f"occupancy {st.mean_occupancy:.2f}"
        )
    lines.append(
        f"fleet: {s['n_finished']} finished, "
        f"{_fmt_or_dash(s['throughput_tok_s'], '.1f')} tok/s, "
        f"TTFT p50={_fmt_or_dash(s['ttft_p50_s'], '.3f')}s "
        f"p99={_fmt_or_dash(s['ttft_p99_s'], '.3f')}s, "
        f"acceptance {_fmt_or_dash(s['mean_acceptance'], '.2f')}"
        + (f", SLO {s['slo_attainment']:.0%} of {s['n_deadlined']} "
           f"(slack p50 {s['slack_p50_s']:+.3f}s p10 {s['slack_p10_s']:+.3f}s)"
           if s["n_deadlined"] else "")
    )
    return "\n".join(lines)

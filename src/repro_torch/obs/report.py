"""Round-time decomposition — the paper's draft/verify imbalance, measured.

Folds a ``Tracer``'s spans into a per-round latency breakdown: how much of
each serving round went to draft-tree work (expansion + KV reconciliation
after re-root), target verification (dispatch + the verified-token device
sync), and host-side absorption.  With async disaggregation on
(``SpecConfig.async_rounds``) the breakdown additionally measures the
pipeline's whole point: the wall time where ``draft_lookahead`` ran *inside*
the open verify window (``overlap_draft_verify_s``), and the draft time that
stayed serialized on the critical path (``draft_serialized_s`` /
``draft_serialized_frac`` — the number async mode exists to shrink).

Span taxonomy (docs/observability.md):
  round         one global serving round on one replica track
  ├─ verify_dispatch   target verification window; lockstep: the enqueue
  │                    only (async dispatch), async rounds: held open from
  │                    dispatch until the verified tokens land
  ├─ draft_expand      the d concurrent tree expansions (lockstep parallel mode)
  ├─ draft_lookahead   async: next round's tree drafted on the predicted-
  │                    accept path while verify is still in flight
  ├─ sync_emitted      host sync on the verified-token transfer
  ├─ reroot_grow       tree re-root + KV fill + regrow + next plan (lockstep)
  ├─ reconcile         async: rollback + re-root after a rejected lookahead seed
  └─ absorb            host-side token absorption / retire / stream

``kv_move`` is a nested *detail* span (inside verify_dispatch, reroot_grow,
draft_lookahead, or reconcile): the KV-reorganization dispatch that the
fused row-move kernels attack (docs/kernels.md).  It is reported on its own
``kv_move_s``/``kv_move_frac`` keys but deliberately kept out of
ROUND_PHASES so the coverage/overlap unions never double-count its parent.

Because async phases genuinely overlap (that is the feature), coverage and
the overlap metrics are computed on interval *unions* per round, never by
summing durations — a nested span can't push coverage past 1.0 or count the
same wall-clock millisecond twice.

A copy of ``repro.obs.report``,
framework-neutral: the port imports nothing of ``repro``.
"""

from __future__ import annotations

# top-level phases inside one round span (nested spans, e.g. ``retire``
# inside ``absorb``, are excluded so coverage never double-counts)
ROUND_PHASES = ("verify_dispatch", "draft_expand", "draft_lookahead",
                "sync_emitted", "reconcile", "reroot_grow", "absorb")
PHASE_GROUPS = {
    "draft": ("draft_expand", "draft_lookahead", "reconcile", "reroot_grow"),
    "verify": ("verify_dispatch", "sync_emitted"),
    "absorb": ("absorb",),
}
# nested detail spans: measured and reported on their own keys but NEVER
# part of the coverage/overlap unions — they live inside a ROUND_PHASES
# parent (kv_move = the cache-reorganization dispatch inside verify_dispatch
# / reroot_grow / draft_lookahead / reconcile; see docs/kernels.md)
DETAIL_PHASES = ("kv_move",)


def _merge(intervals):
    """Coalesce [t0, t1) intervals into a sorted disjoint union."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _length(intervals) -> float:
    return sum(t1 - t0 for t0, t1 in intervals)


def _intersect(a, b):
    """Intersection of two sorted disjoint interval unions."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def phase_breakdown(tracer) -> dict:
    """Decompose every ``round`` span into its phase children.

    Returns per-phase totals/fractions, the draft/verify/absorb grouping,
    span coverage (union of phase intervals over round wall time — the
    instrument-completeness check; ≥0.95 means the trace explains where each
    round's milliseconds went), and the async-pipeline evidence:
    ``overlap_draft_verify_s`` (draft wall time inside the verify window)
    and ``draft_serialized_s``/``draft_serialized_frac`` (draft wall time
    still on the critical path)."""
    spans = tracer.spans()
    rounds = sorted((s for s in spans if s.name == "round"),
                    key=lambda s: (s.track, s.t0))
    by_track: dict[str, list] = {}
    detail_by_track: dict[str, list] = {}
    for s in spans:
        if s.name in ROUND_PHASES:
            by_track.setdefault(s.track, []).append(s)
        elif s.name in DETAIL_PHASES:
            detail_by_track.setdefault(s.track, []).append(s)
    for v in by_track.values():
        v.sort(key=lambda s: s.t0)
    for v in detail_by_track.values():
        v.sort(key=lambda s: s.t0)

    phase_s = dict.fromkeys(ROUND_PHASES, 0.0)
    detail_s = dict.fromkeys(DETAIL_PHASES, 0.0)
    coverages: list[float] = []
    round_total = 0.0
    overlap_s = 0.0
    draft_union_s = 0.0
    cursor = dict.fromkeys(by_track, 0)  # per-track scan position
    dcursor = dict.fromkeys(detail_by_track, 0)
    for r in rounds:
        round_total += r.dur
        kids_here: list = []
        kids = by_track.get(r.track, ())
        i = cursor.get(r.track, 0)
        # skip children that ended before this round began (earlier rounds)
        while i < len(kids) and kids[i].t0 < r.t0:
            i += 1
        cursor[r.track] = i
        while i < len(kids) and kids[i].t0 < r.t1:
            if kids[i].t1 <= r.t1:
                phase_s[kids[i].name] += kids[i].dur
                kids_here.append(kids[i])
            i += 1
        dkids = detail_by_track.get(r.track, ())
        j = dcursor.get(r.track, 0)
        while j < len(dkids) and dkids[j].t0 < r.t0:
            j += 1
        dcursor[r.track] = j
        while j < len(dkids) and dkids[j].t0 < r.t1:
            if dkids[j].t1 <= r.t1:
                detail_s[dkids[j].name] += dkids[j].dur
            j += 1
        covered = _length(_merge([(k.t0, k.t1) for k in kids_here]))
        if r.dur > 0:
            coverages.append(covered / r.dur)
        draft_win = _merge([(k.t0, k.t1) for k in kids_here
                            if k.name in PHASE_GROUPS["draft"]])
        verify_win = _merge([(k.t0, k.t1) for k in kids_here
                             if k.name in PHASE_GROUPS["verify"]])
        overlap_s += _length(_intersect(draft_win, verify_win))
        draft_union_s += _length(draft_win)

    # zero rounds (empty trace) must read as "unknown", not "instantaneous":
    # a 0.0 mean_round_s or coverage from a dead tracer would sail straight
    # through dashboards and the CI coverage gate, so every ratio whose
    # denominator is empty is nan-marked instead
    nan = float("nan")
    out = {
        "n_rounds": len(rounds),
        "round_total_s": round_total,
        "mean_round_s": round_total / len(rounds) if rounds else nan,
        "phase_s": phase_s,
        "phase_frac": {
            k: (v / round_total if round_total else nan) for k, v in phase_s.items()
        },
        "coverage_mean": sum(coverages) / len(coverages) if coverages else nan,
        "coverage_min": min(coverages) if coverages else nan,
        # async-pipeline evidence: draft wall time hidden under the verify
        # window vs. still serialized on the critical path (union-based, so
        # lockstep traces report overlap == 0.0 exactly)
        "overlap_draft_verify_s": overlap_s,
        "draft_serialized_s": draft_union_s - overlap_s,
        "draft_serialized_frac": (
            (draft_union_s - overlap_s) / round_total if round_total else nan
        ),
        # nested detail: wall time of the KV-reorganization dispatch (the
        # fused kv_move_rows path) across ALL round phases it nests inside
        "kv_move_s": detail_s["kv_move"],
        "kv_move_frac": detail_s["kv_move"] / round_total if round_total else nan,
    }
    for group, members in PHASE_GROUPS.items():
        tot = sum(phase_s[m] for m in members)
        out[f"{group}_s"] = tot
        out[f"{group}_frac"] = tot / round_total if round_total else nan
    return out


def breakdown_report(bd: dict) -> str:
    """Human-readable view of ``phase_breakdown`` output."""
    if not bd["n_rounds"]:
        return "phase breakdown: no rounds traced"
    lines = [
        f"phase breakdown over {bd['n_rounds']} rounds "
        f"(mean round {bd['mean_round_s'] * 1e3:.2f} ms, "
        f"span coverage mean={bd['coverage_mean']:.1%} min={bd['coverage_min']:.1%})"
    ]
    for name in ROUND_PHASES:
        lines.append(f"  {name:15s} {bd['phase_s'][name] * 1e3:9.2f} ms "
                     f"{bd['phase_frac'][name]:6.1%}")
    lines.append(f"  {'~ kv_move':15s} {bd['kv_move_s'] * 1e3:9.2f} ms "
                 f"{bd['kv_move_frac']:6.1%}  (nested in the phases above)")
    lines.append(
        f"  => draft {bd['draft_frac']:.1%} / verify {bd['verify_frac']:.1%} "
        f"/ absorb {bd['absorb_frac']:.1%} of round wall time"
    )
    lines.append(
        f"  => draft overlapped with verify {bd['overlap_draft_verify_s'] * 1e3:.2f} ms, "
        f"serialized {bd['draft_serialized_s'] * 1e3:.2f} ms "
        f"({bd['draft_serialized_frac']:.1%} of round)"
    )
    return "\n".join(lines)

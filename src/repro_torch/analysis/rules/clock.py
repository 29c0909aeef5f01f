"""CLOCK — raw wall-clock reads bypass the injected Clock abstraction (a
copy of the reference's rule).

Serving latency numbers (TTFT, tok/s, phase spans) are only comparable when
every timestamp flows through one clock: the runtimes' injectable
``WallClock``/``VirtualClock`` or ``repro_torch.obs.clock.monotonic`` (the single
sanctioned raw read, itself carrying the one inline suppression).  A stray
``time.time()`` silently mixes non-monotonic wall time into monotonic
timelines and makes VirtualClock benchmarks lie.

Flags *references* (not just calls) to ``time.time`` / ``perf_counter`` /
``monotonic`` and friends, following import aliases — passing
``time.perf_counter`` as a default callback is exactly the bypass the rule
exists to catch.  ``time.sleep`` is allowed (it spends time, it does not
read it).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Finding, ImportMap, Rule, register

BANNED = frozenset({
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "time.clock_gettime", "time.clock_gettime_ns",
})


@register
class ClockRule(Rule):
    name = "CLOCK"
    description = ("raw wall-clock reads (time.time/perf_counter/...) outside "
                   "the Clock abstraction")

    def check(self, ctx: FileContext, project) -> list[Finding]:
        imports = ImportMap(ctx.tree)
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            # only the outermost attribute chain: time.perf_counter is one
            # reference, not also a reference to `time`
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                continue
            resolved = imports.resolve(node)
            if resolved in BANNED:
                findings.append(ctx.finding(
                    self.name, node,
                    f"raw wall-clock read `{resolved}` — inject a Clock or "
                    f"use repro_torch.obs.clock.monotonic()"))
        # de-duplicate nested chains (Attribute visits its child Name too):
        # keep one finding per (line, col)
        seen, out = set(), []
        for f in findings:
            if (f.line, f.col) not in seen:
                seen.add((f.line, f.col))
                out.append(f)
        return out

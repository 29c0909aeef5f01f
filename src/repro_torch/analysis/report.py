"""Reporters: human text and machine JSON, sharing one summary shape."""

from __future__ import annotations

import collections
import json

from repro_torch.analysis.core import REGISTRY, Finding


def summarize(findings: list[Finding], stale: list[str]) -> dict:
    by_rule = collections.Counter(f.rule for f in findings if not f.baselined)
    return {
        "total": len(findings),
        "new": sum(1 for f in findings if not f.baselined),
        "baselined": sum(1 for f in findings if f.baselined),
        "by_rule": dict(sorted(by_rule.items())),
        "stale_baseline": stale,
    }


def render_text(findings: list[Finding], stale: list[str], n_files: int) -> str:
    lines = [f.format() for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.col, f.rule))]
    for fp in stale:
        lines.append(f"baseline: stale entry {fp} matches no finding — "
                     f"remove it (or restore the code it covered)")
    s = summarize(findings, stale)
    verdict = "clean" if not s["new"] and not stale else "FAIL"
    lines.append(
        f"repro_torch.analysis: {n_files} files, {s['new']} new finding(s), "
        f"{s['baselined']} baselined, {len(stale)} stale baseline "
        f"entr{'y' if len(stale) == 1 else 'ies'} -> {verdict}")
    return "\n".join(lines)


def render_json(findings: list[Finding], stale: list[str], n_files: int) -> str:
    doc = {
        "version": 1,
        "files": n_files,
        "findings": [f.to_json() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.col, f.rule))],
        "summary": summarize(findings, stale),
        "rules": {r.name: r.description for r in REGISTRY.values()},
    }
    return json.dumps(doc, indent=1)

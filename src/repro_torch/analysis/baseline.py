"""Baseline: grandfathered findings, checked in with a justification.

The baseline is a JSON file mapping finding fingerprints to a reason
string.  A finding whose fingerprint is in the baseline is reported as
``[baselined]`` and does not fail the run; a baseline entry that no longer
matches ANY finding is *stale* and fails the run (otherwise deleted
violations would leave dead entries behind, and re-introduced ones could
hide under them).

Fingerprints hash the rule + root-relative path + the stripped source line
(+ an occurrence index), so unrelated line-number drift does not invalidate
the baseline, but touching the flagged line itself does — deliberately:
grandfathering covers existing code, not edits to it.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.analysis.core import Finding


def load_baseline(path: str) -> dict[str, str]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", doc)  # tolerate a bare mapping
    if not isinstance(entries, dict):
        raise ValueError(f"{path}: baseline `entries` must be an object")
    return {str(k): str(v) for k, v in entries.items()}


def write_baseline(path: str, findings: list[Finding], reason: str) -> int:
    """Write every (non-baselined-marked) finding as a baseline entry."""
    entries = {f.fingerprint: f"{reason} [{f.rule} {f.path}:{f.line}]"
               for f in findings}
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1, sort_keys=True)
        f.write("\n")
    return len(entries)


def apply_baseline(findings: list[Finding], baseline: dict[str, str]):
    """Split findings into (all, with baselined flags set) and the stale
    baseline fingerprints that matched nothing."""
    matched: set[str] = set()
    out = []
    for f in findings:
        fp = f.fingerprint
        if fp in baseline:
            matched.add(fp)
            out.append(dataclasses.replace(f, baselined=True))
        else:
            out.append(f)
    stale = sorted(set(baseline) - matched)
    return out, stale

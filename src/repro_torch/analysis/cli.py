"""``python -m repro_torch.analysis`` — the CLI and exit-code semantics.

Exit codes:
  0  clean: no new findings, no stale baseline entries
  1  new findings and/or stale baseline entries
  2  usage/internal error (no files matched, unknown rule, bad baseline)

Typical invocations::

  python -m repro_torch.analysis src/repro_torch            # gate the port
  python -m repro_torch.analysis src/repro_torch --format json
  python -m repro_torch.analysis src/repro_torch --write-baseline \
      src/repro_torch/analysis/analysis-baseline.json --reason "..."  # (re)baseline

The port's baseline is its own file inside this package (``DEFAULT_BASELINE``),
apart from the reference's ``analysis-baseline.json``; the default path is
the port's package, ``src/repro_torch``.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import rules as _rules  # noqa: F401 — populates REGISTRY
from repro_torch.analysis.baseline import apply_baseline, load_baseline, write_baseline
from repro_torch.analysis.core import REGISTRY, analyze_file, iter_py_files
from repro_torch.analysis.project import build_project_context
from repro_torch.analysis.report import render_json, render_text

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # src/repro_torch
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "analysis-baseline.json")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch-aware static analysis guarding the port's hot "
                    "decode round (rules: %s)" % ", ".join(sorted(REGISTRY)))
    ap.add_argument("paths", nargs="*", default=[PACKAGE],
                    help="files or directories to scan (default: src/repro_torch)")
    ap.add_argument("--format", choices=["text", "json"], default="text")
    ap.add_argument("--output", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: the package's "
                         "analysis-baseline.json when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write ALL current findings as the new baseline and "
                         "exit 0")
    ap.add_argument("--reason", default="grandfathered",
                    help="justification recorded with --write-baseline entries")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.list_rules:
        for name in sorted(REGISTRY):
            print(f"{name:10s} {REGISTRY[name].description}")
        return 0

    rules = None
    if args.rules:
        want = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in want if r not in REGISTRY]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(have: {', '.join(sorted(REGISTRY))})", file=sys.stderr)
            return 2
        rules = [REGISTRY[r] for r in want]

    files = list(iter_py_files(args.paths))
    if not files:
        print(f"no python files under: {' '.join(args.paths)}", file=sys.stderr)
        return 2

    project = build_project_context(args.paths)
    findings = []
    for abspath, root in files:
        findings.extend(analyze_file(abspath, root, project, rules))

    if args.write_baseline:
        n = write_baseline(args.write_baseline, findings, args.reason)
        print(f"wrote {n} baseline entr{'y' if n == 1 else 'ies'} -> "
              f"{args.write_baseline}")
        return 0

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    stale: list[str] = []
    if baseline_path and not args.no_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"cannot load baseline {baseline_path}: {e}", file=sys.stderr)
            return 2
        findings, stale = apply_baseline(findings, baseline)

    render = render_json if args.format == "json" else render_text
    text = render(findings, stale, len(files))
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)

    new = sum(1 for f in findings if not f.baselined)
    return 1 if (new or stale) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

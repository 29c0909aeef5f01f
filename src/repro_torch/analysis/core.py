"""Framework core: findings, the rule registry, suppressions, the runner
(a copy of ``repro.analysis.core`` with the port's own marker).

The pass is deliberately pure-stdlib (``ast`` only, no torch import): it
must run in a bare CI job in milliseconds and must never initialize a
device backend just to lint the tree.

One ``FileContext`` is built per analyzed file (one parse, one suppression
scan) and every registered rule is dispatched over it.  Findings carry a
*fingerprint* — rule + root-relative path + the stripped source line + an
occurrence index — so the baseline survives unrelated line-number drift but
goes stale (loudly) when the flagged code itself changes or disappears.

Suppressions: ``# repro_torch: disable=RULE[,RULE...] — reason`` on the
violating line, or on a standalone comment line directly above it.  A
suppression that matches no finding is itself reported (rule
``UNUSED-SUPPRESS``), so stale escapes cannot accumulate silently.  The
reference's linter reads ``# repro: disable=`` and this one does not, nor
does the reference's read this one's: each sees only its own escapes.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
import tokenize


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # root-relative posix path (stable across machines)
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line, the fingerprint's anchor
    occurrence: int = 0  # index among identical (rule, path, snippet)
    baselined: bool = False
    suppressed: bool = False  # silenced by a suppression (kept only when asked for)

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{self.snippet}".encode()
        ).hexdigest()[:16]
        return f"{h}#{self.occurrence}"

    def format(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{tag}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "baselined": self.baselined,
        }


_DISABLE_RE = re.compile(r"#\s*repro_torch:\s*disable=([A-Z0-9_,\-]+)")


@dataclasses.dataclass
class _Suppression:
    line: int  # comment's own line
    rules: tuple[str, ...]
    used: bool = False


class FileContext:
    """One file's parse + line table + suppression table, shared by rules."""

    def __init__(self, abspath: str, relpath: str, source: str):
        self.abspath = abspath
        self.path = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)  # may raise SyntaxError
        self.suppressions = self._scan_suppressions(source)

    @staticmethod
    def _scan_suppressions(source: str) -> list[_Suppression]:
        out = []
        import io

        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DISABLE_RE.search(tok.string)
                if m:
                    rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
                    out.append(_Suppression(line=tok.start[0], rules=rules))
        except tokenize.TokenError:  # unterminated string etc.: parse will flag it
            pass
        return out

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def is_suppressed(self, rule: str, lineno: int) -> bool:
        """Same-line or directly-above suppression; marks the escape used."""
        hit = False
        for sup in self.suppressions:
            if rule in sup.rules and sup.line in (lineno, lineno - 1):
                sup.used = hit = True
        return hit

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.path, line=line, col=col,
                       message=message, snippet=self.line_text(line))


class Rule:
    """Base rule: subclass, set ``name``/``description``, implement check()."""

    name = "RULE"
    description = ""

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, ctx: FileContext, project) -> list[Finding]:
        raise NotImplementedError


REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator adding one rule instance to the global registry."""
    inst = cls()
    REGISTRY[inst.name] = inst
    return cls


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def iter_py_files(paths: list[str]):
    """Yield (abspath, root) pairs; ``root`` is the scan root the file was
    found under (fingerprint paths are relative to it, so the same tree
    scanned from anywhere produces the same fingerprints)."""
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            yield p, os.path.dirname(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn), p


def analyze_file(abspath: str, root: str, project, rules=None,
                 with_suppressed: bool = False) -> list[Finding]:
    """The findings of one file; ``with_suppressed`` also returns the
    suppressed ones, marked ``suppressed``."""
    relpath = os.path.relpath(abspath, root).replace(os.sep, "/")
    with open(abspath, encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = FileContext(abspath, relpath, source)
    except SyntaxError as e:
        return [Finding(rule="PARSE", path=relpath, line=e.lineno or 1,
                        col=e.offset or 0, message=f"syntax error: {e.msg}",
                        snippet="")]
    findings: list[Finding] = []
    for rule in (rules if rules is not None else REGISTRY.values()):
        if not rule.applies_to(relpath):
            continue
        for f_ in rule.check(ctx, project):
            if not ctx.is_suppressed(f_.rule, f_.line):
                findings.append(f_)
            elif with_suppressed:
                findings.append(dataclasses.replace(f_, suppressed=True))
    for sup in ctx.suppressions:
        if not sup.used:
            findings.append(Finding(
                rule="UNUSED-SUPPRESS", path=relpath, line=sup.line, col=0,
                message=f"suppression for {','.join(sup.rules)} matches no "
                        f"finding — delete it",
                snippet=ctx.line_text(sup.line)))
    return _index_occurrences(findings)


def _index_occurrences(findings: list[Finding]) -> list[Finding]:
    """Disambiguate identical (rule, path, snippet) findings by order."""
    seen: dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.snippet)
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(dataclasses.replace(f, occurrence=n))
    return out


def analyze_paths(paths: list[str], project, rules=None) -> list[Finding]:
    out: list[Finding] = []
    for abspath, root in iter_py_files(paths):
        out.extend(analyze_file(abspath, root, project, rules))
    return out


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------


def qualname(node: ast.AST) -> str | None:
    """Dotted name of a Name/Attribute chain (``jax.lax.psum``), else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ImportMap(ast.NodeVisitor):
    """Local name -> canonical dotted module/symbol path for a module."""

    def __init__(self, tree: ast.Module):
        self.names: dict[str, str] = {}
        self.visit(tree)

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.names[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module is None:
            return
        for a in node.names:
            self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted path of a Name/Attribute reference, following the
        module's import aliases (``pc()`` -> ``time.perf_counter``)."""
        q = qualname(node)
        if q is None:
            return None
        head, _, rest = q.partition(".")
        base = self.names.get(head)
        if base is None:
            return q
        return f"{base}.{rest}" if rest else base

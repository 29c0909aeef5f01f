"""AXIS — axis-name literals cross-checked against the declared vocabulary.

``parallel.rules.spec_for`` replicates a dimension whose logical axis it
does not know, as JAX does: a typo in an axis name does not error, it just
erases the split the table claims.  Every string literal used as an axis
name is therefore checked against the axes the port declares (extracted
from ``parallel/rules.py``'s ``DEFAULT_RULES`` and ``launch/mesh.py``'s
meshes by ``repro_torch.analysis.project``):

  * logical axes: the values of the dict literals in ``models/axes.py``
    (the weights' axis tables) and the ``axes`` argument of ``spec_for`` /
    ``model_dim`` calls;
  * mesh axes: the keys of a dict literal given as their ``mesh``
    argument, the ``axis=`` of a ``CountingGroup``, and a string subscript
    or ``.get`` of a variable named ``mesh``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import FileContext, Finding, Rule, register

_SPEC_FNS = frozenset({"spec_for", "model_dim"})


def _axis_strs(node: ast.AST):
    """String constants in an axis argument (a str, or nested tuples/lists)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value, node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _axis_strs(elt)


def _fn_name(call: ast.Call) -> str | None:
    fn = call.func
    return fn.attr if isinstance(fn, ast.Attribute) else (fn.id if isinstance(fn, ast.Name)
                                                          else None)


def _is_mesh(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "mesh"


@register
class AxisRule(Rule):
    name = "AXIS"
    description = ("logical-axis names in models/axes.py and spec_for calls, mesh-axis names, "
                   "checked against parallel/rules.py + launch/mesh.py declarations")

    def check(self, ctx: FileContext, project) -> list[Finding]:
        findings: list[Finding] = []
        logical, mesh = project.logical_axes, project.mesh_axes
        if ctx.path.rsplit("/", 1)[-1] == "axes.py":  # the weights' axis tables
            for node in ctx.tree.body:
                value = getattr(node, "value", None)
                if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(value, ast.Dict):
                    for v in value.values:
                        findings.extend(self._check(ctx, v, logical, "logical"))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = _fn_name(node)
                if name in _SPEC_FNS:
                    axes = node.args[1:2] + [kw.value for kw in node.keywords if kw.arg == "axes"]
                    for arg in axes:
                        findings.extend(self._check(ctx, arg, logical, "logical"))
                    first = node.args[:1] + [kw.value for kw in node.keywords
                                             if kw.arg == "mesh"]
                    for arg in first:
                        if isinstance(arg, ast.Dict):
                            for k in arg.keys:
                                if k is not None:
                                    findings.extend(self._check(ctx, k, mesh, "mesh"))
                elif name == "CountingGroup":
                    for kw in node.keywords:
                        if kw.arg == "axis":
                            findings.extend(self._check(ctx, kw.value, mesh, "mesh"))
                elif name == "get" and isinstance(node.func, ast.Attribute) and \
                        _is_mesh(node.func.value) and node.args:
                    findings.extend(self._check(ctx, node.args[0], mesh, "mesh"))
            elif isinstance(node, ast.Subscript) and _is_mesh(node.value):
                findings.extend(self._check(ctx, node.slice, mesh, "mesh"))
        return findings

    def _check(self, ctx, arg, declared, kind) -> list[Finding]:
        out = []
        for name, node in _axis_strs(arg):
            if name not in declared:
                close = _closest(name, declared)
                hint = f" (did you mean {close!r}?)" if close else ""
                out.append(ctx.finding(
                    self.name, node,
                    f"unknown {kind} axis {name!r} — declared {kind} axes: "
                    f"{sorted(declared)}{hint}"))
        return out


def _closest(name: str, declared) -> str | None:
    import difflib

    m = difflib.get_close_matches(name, list(declared), n=1, cutoff=0.6)
    return m[0] if m else None

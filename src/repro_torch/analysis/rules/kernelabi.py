"""KERNELABI — the ctypes signatures of the kernels against their C
declarations (the reference's PALLAS rule's counterpart).

A kernel library is loaded with ``ctypes`` (``kernels/build.py``), whose
``SIGNATURES`` table gives each exported function's argument types.  A
table one argument short, or with an ``int`` where the C side takes a
pointer, is not an error anywhere: the kernel reads garbage for the
argument, and the card computes something else.  So every ``SIGNATURES``
entry is checked against the ``REPRO_EXPORT`` declaration of the same
function in the library's sources (``csrc/*.cu`` and ``csrc/*.cuh`` beside
the table), argument by argument: the count, and the type class — a
pointer (``cudaStream_t`` included) is ``c_void_p``, ``int`` ``c_int``,
``float`` ``c_float``, ``long long`` ``c_longlong``.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from repro_torch.analysis.core import FileContext, Finding, Rule, register

_EXPORT_RE = re.compile(r"REPRO_EXPORT\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)", re.S)
_CTYPES = {"c_void_p": "pointer", "c_int": "int", "c_float": "float", "c_longlong": "long long"}


def _c_class(param: str) -> str:
    """The type class of one C parameter declaration."""
    p = re.sub(r"/\*.*?\*/", "", param).strip()
    if "*" in p or "cudaStream_t" in p:
        return "pointer"
    words = p.replace("const", "").split()[:-1]  # drop the parameter's name
    return " ".join(words)


def c_declarations(csrc: str) -> dict[str, tuple[list[str], str]]:
    """function -> (its parameters' type classes, the file declaring it),
    for every ``REPRO_EXPORT`` function of the sources in ``csrc``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu")) +
                       glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, encoding="utf-8") as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for m in _EXPORT_RE.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip() and p.strip() != "void"]
            out[m.group(1)] = ([_c_class(p) for p in params], os.path.basename(path))
    return out


class _Eval:
    """Evaluates a ``SIGNATURES`` argument list (``[_P] * 8 + [_I, _F]``)
    to ctypes type names, names bound at module level followed."""

    def __init__(self, tree: ast.Module):
        self.names: dict[str, str] = {}
        for node in tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t, v = node.targets[0], node.value
            pairs = zip(t.elts, v.elts) if isinstance(t, ast.Tuple) and \
                isinstance(v, ast.Tuple) else [(t, v)]
            for name, val in pairs:
                if isinstance(name, ast.Name) and isinstance(val, ast.Attribute):
                    self.names[name.id] = val.attr

    def __call__(self, node: ast.AST) -> list[str] | None:
        if isinstance(node, ast.List):
            out = []
            for elt in node.elts:
                if isinstance(elt, ast.Name) and elt.id in self.names:
                    out.append(self.names[elt.id])
                elif isinstance(elt, ast.Attribute):
                    out.append(elt.attr)
                else:
                    return None
            return out
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Add):
                a, b = self(node.left), self(node.right)
                return None if a is None or b is None else a + b
            if isinstance(node.op, ast.Mult) and isinstance(node.right, ast.Constant):
                a = self(node.left)
                return None if a is None else a * int(node.right.value)
        return None


@register
class KernelAbiRule(Rule):
    name = "KERNELABI"
    description = ("kernels/build.py SIGNATURES entries against the REPRO_EXPORT "
                   "declarations in csrc/ (argument count and type class)")

    def applies_to(self, relpath: str) -> bool:
        return relpath.rsplit("/", 1)[-1] == "build.py"

    def check(self, ctx: FileContext, project) -> list[Finding]:
        table = next((n.value for n in ctx.tree.body if isinstance(n, ast.Assign)
                      and any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                              for t in n.targets) and isinstance(n.value, ast.Dict)), None)
        if table is None:
            return []
        decls = c_declarations(os.path.join(os.path.dirname(ctx.abspath), "csrc"))
        evaluate = _Eval(ctx.tree)
        out = []
        for lib in table.values:
            if not isinstance(lib, ast.Dict):
                continue
            for key, value in zip(lib.keys, lib.values):
                if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                    continue
                fn = key.value
                args = evaluate(value)
                if fn not in decls:
                    out.append(ctx.finding(self.name, key, f"`{fn}` has no REPRO_EXPORT "
                                                           "declaration in csrc/"))
                    continue
                params, src = decls[fn]
                if args is None:
                    out.append(ctx.finding(self.name, value, f"`{fn}`: argument types are "
                                                             "not a list the rule can read"))
                elif len(args) != len(params):
                    out.append(ctx.finding(
                        self.name, value,
                        f"`{fn}`: SIGNATURES gives {len(args)} argument(s), {src} declares "
                        f"{len(params)} — a missing argument is read as garbage"))
                else:
                    for i, (a, p) in enumerate(zip(args, params)):
                        if _CTYPES.get(a) != p:
                            out.append(ctx.finding(
                                self.name, value,
                                f"`{fn}` argument {i}: SIGNATURES gives {a}, {src} declares "
                                f"{p}"))
        return out

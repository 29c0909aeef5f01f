"""Project context: the declared mesh/logical axis vocabulary.

AXIS findings are only as good as the set they check against, so the
context is extracted from the port's own declarations — the
``DEFAULT_RULES`` table in ``parallel/rules.py`` (keys = logical axes,
values = the mesh axes they map onto) and the meshes of
``launch/mesh.py`` (the string keys of its ``{axis: size}`` dict literals,
``production_mesh``'s).  Editing either file updates the checker
automatically; the fallback constants below only cover scans (e.g. test
snippets) that don't contain those files.
"""

from __future__ import annotations

import ast
import dataclasses
import os

# fallbacks mirroring parallel/rules.py + launch/mesh.py, used only
# when the scanned tree does not carry its own declarations
FALLBACK_MESH_AXES = frozenset({"model", "data", "pod"})
FALLBACK_LOGICAL_AXES = frozenset({
    "batch", "seq", "act_seq", "act_embed", "embed", "heads", "kv_heads",
    "head_dim", "qk_dim", "ff", "vocab", "experts", "experts_ep", "inner",
    "state", "conv", "lora", "unit", "layers", "kv_seq", "cache_batch",
})


@dataclasses.dataclass
class ProjectContext:
    mesh_axes: frozenset[str] = FALLBACK_MESH_AXES
    logical_axes: frozenset[str] = FALLBACK_LOGICAL_AXES
    rules_file: str | None = None  # where the declarations were found
    mesh_file: str | None = None


def _str_consts(node: ast.AST):
    """Every string constant anywhere under ``node``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def _extract_rules_table(path: str):
    """(logical axes, mesh axes) from a ``DEFAULT_RULES = {...}`` literal."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    logical, mesh = set(), set()
    for node in ast.walk(tree):
        # plain or annotated assignment (DEFAULT_RULES: dict[...] = {...})
        if isinstance(node, ast.Assign) and node.targets:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if not (isinstance(target, ast.Name) and target.id == "DEFAULT_RULES"
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                logical.add(k.value)
            mesh.update(_str_consts(v))
    return logical, mesh


def _extract_mesh_axes(path: str):
    """The string keys of the ``{axis: size}`` dict literals (the meshes)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    axes = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            axes.update(k.value for k in node.keys
                        if isinstance(k, ast.Constant) and isinstance(k.value, str))
    return axes


def build_project_context(paths: list[str]) -> ProjectContext:
    """Locate the axis declarations under the scanned roots (or beside a
    scanned file) and build the context; fall back to the baked-in sets."""
    ctx = ProjectContext()
    candidates_rules, candidates_mesh = [], []
    for p in paths:
        p = os.path.abspath(p)
        root = os.path.dirname(p) if os.path.isfile(p) else p
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            if os.path.basename(dirpath) == "parallel" and "rules.py" in filenames:
                candidates_rules.append(os.path.join(dirpath, "rules.py"))
            if "mesh.py" in filenames and os.path.basename(dirpath) == "launch":
                candidates_mesh.append(os.path.join(dirpath, "mesh.py"))
    logical, mesh = set(), set()
    for path in candidates_rules:
        try:
            lg, ms = _extract_rules_table(path)
        except (OSError, SyntaxError):
            continue
        if lg:
            logical |= lg
            mesh |= ms
            ctx.rules_file = path
    for path in candidates_mesh:
        try:
            ms = _extract_mesh_axes(path)
        except (OSError, SyntaxError):
            continue
        if ms:
            mesh |= ms
            ctx.mesh_file = path
    if logical:
        ctx.logical_axes = frozenset(logical)
    if mesh:
        ctx.mesh_axes = frozenset(mesh)
    return ctx

"""HOTSYNC — host syncs inside the port's hot decode round (torch-aware).

SwiftSpec's round overlaps draft and target work; ONE designated host sync
per round (the verified tokens' transfer) is the contract.  On the card any
other read of a CUDA tensor on the host waits for the stream and serializes
the very overlap the system exists to create.

Flags, inside the hot scopes:

  * ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` on any value;
  * ``torch.cuda.synchronize`` and ``.synchronize()`` of an ``Event`` or a
    ``Stream``;
  * ``int()``, ``float()``, ``bool()``, the builtins that iterate
    (``max()``, ``min()``, ``sum()``, ``any()``, ``all()``, ``list()``,
    ``tuple()``, ``sorted()``) and ``np.asarray()``/``np.array()`` of a
    tensor expression (one that calls ``torch.*`` or a reducing tensor
    method such as ``.sum()``/``.any()``, or reads a name the method
    assigned such an expression to: ``int(first[0, 0])``);
  * ``if``/``while`` whose test calls ``torch.*`` (an implicit ``__bool__``;
    the host-side queries ``torch.is_grad_enabled``, ``torch.is_tensor``,
    ``torch.cuda.is_available`` and ``torch.distributed.is_initialized``
    excepted).

Scope: the reference's hot round methods —

  * ``SpecEngine.step`` / ``SpecEngine.generate`` and the chain engine's,
  * every method of ``EngineSession`` and ``ChainSession`` (the bound round
    API) and of ``EngineStepper`` (the per-round admit/absorb/retire path),
  * ``ServingRuntimeBase.run`` and every ``*Runtime.run`` (the round loop) —

and every class of the port whose methods run inside a round:

  * ``Split.plan``, ``Split.share`` and ``Fleet.exchange_rows``
    (``parallel/split.py``): the split's plan and verdict exchange and the
    fleet's row exchange, each round (the profile pass's ``agree_times``
    is not a round's);
  * ``ShardedServingRuntime`` (``serving/router.py``): the router's round.

The designated per-round sync carries an inline
``# repro_torch: disable=HOTSYNC`` with its reason, and so does a line the
rule reads as a sync that reads host memory only (a numpy array, gloo's
CPU tensors), with that reason; everything else is a finding.
"""

from __future__ import annotations

import ast
import fnmatch

from repro_torch.analysis.core import FileContext, Finding, ImportMap, Rule, register

# (class glob, method glob) pairs defining the hot path
HOT_SCOPES = (
    ("SpecEngine", "step"),
    ("SpecEngine", "generate"),
    ("ChainSpecEngine", "step"),
    ("ChainSpecEngine", "generate"),
    ("EngineSession", "*"),
    ("ChainSession", "*"),
    ("EngineStepper", "*"),
    ("ServingRuntimeBase", "run"),
    ("*Runtime", "run"),
    ("Split", "plan"),
    ("Split", "share"),
    ("Fleet", "exchange_rows"),
    ("ShardedServingRuntime", "*"),
)

_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
# calls that read every element of their argument on the host
_HOST_READS = frozenset({"int", "float", "bool", "max", "min", "sum", "any", "all", "list",
                         "tuple", "sorted"})
_NUMPY_READS = frozenset({"numpy.asarray", "numpy.array", "numpy.asanyarray"})
_METADATA = frozenset({"shape", "dtype", "device", "ndim", "size", "dim", "numel",
                       "element_size"})
_REDUCING_METHODS = frozenset({"sum", "any", "all", "max", "min", "argmax", "argmin", "mean",
                               "prod", "count_nonzero", "norm", "equal"})
_HOST_QUERIES = frozenset({
    "torch.is_grad_enabled", "torch.is_tensor", "torch.cuda.is_available",
    "torch.distributed.is_initialized", "torch.distributed.is_available",
    "torch.device", "torch.dtype",
})


def _in_scope(cls_name: str, meth_name: str) -> bool:
    return any(fnmatch.fnmatch(cls_name, cg) and fnmatch.fnmatch(meth_name, mg)
               for cg, mg in HOT_SCOPES)


def _torch_calls(node: ast.AST, imports: ImportMap):
    """The calls under ``node`` whose function resolves to ``torch.*``
    (host queries excepted)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            resolved = imports.resolve(sub.func) or ""
            if resolved.startswith("torch.") and resolved not in _HOST_QUERIES:
                yield sub, resolved


def _values(node: ast.AST):
    """The nodes under ``node``, leaving out a tensor's metadata (``x.shape``,
    ``x.size()`` ...), which the host holds."""
    if isinstance(node, ast.Attribute) and node.attr in _METADATA:
        return
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
            node.func.attr in _METADATA:
        return
    yield node
    for child in ast.iter_child_nodes(node):
        yield from _values(child)


def _is_tensor_expr(node: ast.AST, imports: ImportMap, tensors=frozenset()) -> bool:
    if any(True for _ in _torch_calls(node, imports)):
        return True
    return any((isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _REDUCING_METHODS)
               or (isinstance(sub, ast.Name) and sub.id in tensors) for sub in _values(node))


def _tensor_names(meth, imports: ImportMap) -> frozenset:
    """The names ``meth`` assigns a tensor expression to, somewhere."""
    names = set()
    for node in ast.walk(meth):
        if isinstance(node, ast.Assign) and _is_tensor_expr(node.value, imports):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return frozenset(names)


@register
class HotSyncRule(Rule):
    name = "HOTSYNC"
    description = (".item()/.cpu()/.tolist()/.numpy(), synchronize, int/float/bool/max/"
                   "np.asarray ... of a tensor, branching on torch inside the hot decode round")

    def check(self, ctx: FileContext, project) -> list[Finding]:
        imports = ImportMap(ctx.tree)
        findings: list[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if _in_scope(cls.name, meth.name):
                    findings.extend(self._check_method(ctx, imports, cls, meth))
        return findings

    def _check_method(self, ctx, imports, cls, meth) -> list[Finding]:
        out = []
        where = f"{cls.name}.{meth.name}"
        tensors = _tensor_names(meth, imports)
        for node in ast.walk(meth):
            if isinstance(node, ast.Call):
                fn = node.func
                resolved = imports.resolve(fn) or ""
                if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS:
                    out.append(ctx.finding(
                        self.name, node,
                        f"`.{fn.attr}()` inside hot path {where} copies to the host and "
                        f"waits for the stream — keep it to the designated per-round sync"))
                elif resolved == "torch.cuda.synchronize" or (
                        isinstance(fn, ast.Attribute) and fn.attr == "synchronize"):
                    out.append(ctx.finding(
                        self.name, node,
                        f"`{resolved or '.synchronize'}()` inside hot path {where} stalls "
                        f"the host until the card is idle"))
                elif ((isinstance(fn, ast.Name) and fn.id in _HOST_READS)
                      or resolved in _NUMPY_READS) and \
                        node.args and _is_tensor_expr(node.args[0], imports, tensors):
                    out.append(ctx.finding(
                        self.name, node,
                        f"`{resolved}()` of a tensor inside hot path {where} is a blocking "
                        f"transfer"))
            elif isinstance(node, (ast.If, ast.While)):
                for sub, resolved in _torch_calls(node.test, imports):
                    out.append(ctx.finding(
                        self.name, sub,
                        f"branching on `{resolved}` in hot path {where} triggers an "
                        f"implicit __bool__ — a blocking transfer"))
        return out

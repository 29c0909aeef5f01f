"""The cost of one step, counted as it runs (``repro.launch.hlo_parse``'s
counterpart: the reference reads compiled HLO, the port counts the ops).

``count(step, *args)`` runs ``step`` under ``CostCounter``, a
``TorchDispatchMode`` that sees every aten op of the forward and of the
backward, and returns a ``Cost``:

* operations: each op's by ``torch.utils.flop_counter``'s formulas (the
  products; elementwise ops count none, as the reference's parser counts
  only dots);
* bytes: each op's inputs read and outputs written (a view, an alias and
  an uninitialised allocation move none; an expanded input counts its
  distinct elements);
* the collectives of a ``parallel.CountingGroup``, by kind
  (``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast``),
  with their count and operand bytes (a reduce-scatter's operand is its
  whole input, an all-gather's the rank's part: the reference's HLO count
  reads operand sizes too, so a reduce-scatter and an all-gather that
  replace an all-reduce count 1 + 1/ranks of its bytes, where a ring
  moves the same bytes for both forms);
* memory: the arguments' bytes exactly (their storages), and the peak of
  live bytes, every op's output counted from its allocation until its
  storage is freed — autograd's saved tensors live until the backward has
  used them; for a train step also the bytes live when the backward
  starts (the arguments plus what the forward saved for it) and the peak
  up to the backward's end (before the optimizer's new state).

A kernel wrapper (``kernels/ops.py``) and the full attention's core
(``models/attention.py``, ``models/mla.py``) are units
(``kernels.work.counted``): each call counts once, by its formula in
``kernels/work.py``, and no op inside it counts — nor any op of its
backward, which counts once by its backward formula.  The plain version
on the CPU, the meta branch and the CUDA kernel run different ops, so the
work a step counts is the same on the three; the memory is the same on
meta and CUDA, whose wrappers allocate the same outputs and scratch.

Every count is booked to the forward, or to the backward when an op runs
inside the autograd engine (a recomputed unit's forward under
``remat="full"`` and its collectives included).
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

PHASES = ("forward", "backward")
# Under a dispatch mode autograd takes the functional form of a few backward
# formulas (``isTensorSubclassLike`` holds for every tensor then): a fresh
# zeros tensor, then index_put / scatter_add ... out of place, where the run
# without the counter writes the zeros in place.  The count books them as
# the run without it does: the output takes over the zeros' bytes.
_INPLACE_UNLESS_MODE = {
    torch.ops.aten.index_put.default, torch.ops.aten.scatter_add.default,
    torch.ops.aten.scatter.src, torch.ops.aten.scatter.value, torch.ops.aten.index_add.default,
    torch.ops.aten.index_copy.default, torch.ops.aten.masked_scatter.default,
}
_NO_BYTES = {  # ops that allocate without writing
    torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
    torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
}


def _tensors(tree) -> list:
    """The tensors of a pytree, a module's parameters and buffers included."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
            out.extend(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _op_tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (lists of tensors included)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _contiguous(out):
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    if isinstance(out, (list, tuple)) and all(isinstance(t, torch.Tensor) for t in out):
        return type(out)(t.contiguous() for t in out)
    return out


def _read_bytes(t: torch.Tensor) -> int:
    """The distinct elements of ``t`` (an expanded dimension counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class Cost:
    """What a step cost one rank."""

    flops: dict  # phase -> operations
    bytes: dict  # phase -> bytes read and written
    calls: dict  # unit (kernel wrapper, full attention) -> calls, forward and backward
    collectives: dict  # kind -> {"count", "bytes"}, both phases
    collectives_by_phase: dict  # phase -> kind -> {"count", "bytes"}
    collective_axes: dict  # mesh axis -> {"ranks", "bytes"}
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    live_at_backward: int | None = None  # bytes live at the backward's first op
    peak_to_backward_end: int | None = None  # the peak up to the backward's last op

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def collective_bytes(self) -> int:
        return sum(c["bytes"] for c in self.collectives.values())

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def work(self) -> dict:
        """The device-independent part: operations, bytes, unit calls and
        collectives (memory depends on what the plain versions allocate)."""
        return {"flops": dict(self.flops), "bytes": dict(self.bytes), "calls": dict(self.calls),
                "collectives": {k: dict(v) for k, v in self.collectives.items()}}


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it; see the module docstring."""

    def __init__(self):
        super().__init__()
        self.flops = dict.fromkeys(PHASES, 0)
        self.bytes = dict.fromkeys(PHASES, 0)
        self.calls: collections.Counter = collections.Counter()
        self.coll = {p: collections.defaultdict(lambda: {"count": 0, "bytes": 0})
                     for p in PHASES}
        self.axes: dict = {}  # mesh axis -> {"ranks", "bytes"}
        self.live = 0
        self.peak = 0
        self.live_at_backward = None
        self.peak_to_backward_end = None
        self._sizes: dict[int, int] = {}  # id of a live storage -> its bytes
        self._last_out = None  # storage id of the previous op's first output
        self._in_unit = 0  # depth of unit calls: their ops do not count
        self._quiet_nodes: set = set()  # the autograd nodes of the units' backward

    # ---- phases and counts -------------------------------------------------
    @staticmethod
    def phase() -> str:
        return "backward" if torch._C._current_autograd_node() is not None else "forward"

    def _add(self, flops: int, nbytes: int) -> None:
        p = self.phase()
        self.flops[p] += int(flops)
        self.bytes[p] += int(nbytes)

    def collective(self, kind: str, nbytes: int, axis: str = "model", ranks: int = 1) -> None:
        """One collective of a ``CountingGroup`` of ``ranks`` ranks along mesh
        axis ``axis``, ``nbytes`` of operand on this rank."""
        c = self.coll[self.phase()][kind]
        c["count"] += 1
        c["bytes"] += int(nbytes)
        a = self.axes.setdefault(axis, {"ranks": ranks, "bytes": 0})
        a["bytes"] += int(nbytes)

    # ---- memory --------------------------------------------------------------
    def _release(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; returns the bytes
        newly counted (0 for a storage already counted)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return 0
        n = st.nbytes()
        self._sizes[key] = n
        weakref.finalize(st, self._release, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    # ---- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        backward = torch._C._current_autograd_node() is not None
        if backward and self.live_at_backward is None:
            self.live_at_backward = self.live
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else _op_tensors(out, {}) \
            if isinstance(out, (list, tuple)) else []
        if backward and func in _INPLACE_UNLESS_MODE and outs and \
                id(args[0].untyped_storage()) == self._last_out:
            self._sizes[self._last_out] = 0  # the zeros' bytes pass to the output
            self.live -= args[0].untyped_storage().nbytes()
        for t in outs:
            self.track(t)
        self._last_out = id(outs[0].untyped_storage()) if outs else None
        if backward:
            self.peak_to_backward_end = self.peak
        if not self._quiet():
            packet = func._overloadpacket
            flops = flop_registry[packet](*args, **kwargs, out_val=out) \
                if packet in flop_registry else 0
            nbytes = 0
            if not func.is_view and packet not in _NO_BYTES:
                nbytes = sum(_read_bytes(t) for t in _op_tensors(args, kwargs)) + \
                    sum(t.numel() * t.element_size() for t in outs)
            self._add(flops, nbytes)
        return out

    # ---- units -----------------------------------------------------------------
    def _quiet(self) -> bool:
        """Inside a unit, or inside a node of a unit's backward (the engine's
        sum of two gradients for one input included: it runs as part of
        the node that made the second)."""
        if self._in_unit:
            return True
        node = torch._C._current_autograd_node()
        return node is not None and node in self._quiet_nodes

    def unit(self, name, fn, formula, backward, args, kwargs):
        """One call of a ``kernels.work.counted`` function."""
        if self._quiet():
            return fn(*args, **kwargs)
        self.calls[name] += 1
        self._add(*formula(*args, **kwargs))
        self._in_unit += 1
        try:
            # handed on contiguous, as the kernels return them: a plain version's
            # permuted output would change what the next ops copy
            out = _contiguous(fn(*args, **kwargs))
        finally:
            self._in_unit -= 1
        roots = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        # a unit called inside the backward is a recomputed forward, whose
        # graph only hands its saved tensors to the graph that runs
        if backward is not None and roots and self.phase() == "forward":
            inputs = {t.grad_fn for t in _tensors((args, kwargs)) if t.grad_fn is not None}
            self._quiet_backward(name, roots, inputs, backward(*args, **kwargs))
        return out

    def _quiet_backward(self, name, roots, inputs, cost) -> None:
        """Take the autograd nodes the unit made (from its outputs' nodes back
        to its inputs') out of the count; the first of them to run counts
        the unit's backward once."""
        booked = []

        def first(grad_outputs):
            if not booked:
                booked.append(True)
                self.calls[name] += 1
                self._add(*cost)

        todo = list(roots)
        while todo:
            node = todo.pop()
            if node in self._quiet_nodes or node in inputs or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            self._quiet_nodes.add(node)
            node.register_prehook(first)
            todo.extend(n for n, _ in node.next_functions if n is not None)

    # ---- the result ------------------------------------------------------------
    def __enter__(self):
        work.set_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.set_counter(None)
        return super().__exit__(*exc)

    def result(self, argument_bytes: int, output_bytes: int) -> Cost:
        coll = collections.defaultdict(lambda: {"count": 0, "bytes": 0})
        for by_kind in self.coll.values():
            for kind, c in by_kind.items():
                coll[kind]["count"] += c["count"]
                coll[kind]["bytes"] += c["bytes"]
        return Cost(flops=dict(self.flops), bytes=dict(self.bytes), calls=dict(self.calls),
                    collectives=dict(coll),
                    collectives_by_phase={p: {k: dict(v) for k, v in c.items()}
                                          for p, c in self.coll.items()},
                    collective_axes={a: dict(v) for a, v in self.axes.items()},
                    argument_bytes=argument_bytes, output_bytes=output_bytes,
                    peak_bytes=self.peak, live_at_backward=self.live_at_backward,
                    peak_to_backward_end=self.peak_to_backward_end)


def count(step, *args) -> tuple[Cost, object]:
    """Run ``step(*args)`` under a ``CostCounter``; -> (its ``Cost``, what
    it returned).  The arguments' storages count as live from the start."""
    counter = CostCounter()
    arg_bytes = sum(counter.track(t) for t in _tensors(args))
    with counter:
        out = step(*args)
    arg_keys = {id(t.untyped_storage()) for t in _tensors(args)}
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in arg_keys and id(st) not in seen:
            seen.add(id(st))
            out_bytes += st.nbytes()
    return counter.result(arg_bytes, out_bytes), out

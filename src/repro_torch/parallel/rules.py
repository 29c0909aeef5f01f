"""Logical-axis sharding rules (``repro.sharding.rules``), as pure functions.

The reference names every dimension of every parameter with a *logical*
axis ("embed", "heads", "ff", ...) and maps it onto mesh axes through
``DEFAULT_RULES``; ``spec_for`` falls back to replication for a dimension
that the mesh axis does not divide, and never uses one mesh axis twice in
one spec.  Here a mesh is a dict of axis name to size (in order), and a spec
a tuple with one entry per dimension: None, an axis name, or a tuple of
axis names.

The port's weights carry no axes of their own: ``models.axes.weight_axes``
names them.
"""

from __future__ import annotations

import math
from typing import Any

DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",
    "act_embed": None,
    # weights: FSDP ("data") on the large replicated dim, TP ("model") on the
    # split dim; "pod" never shards weights
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": None,  # experts replicated; ff-within-expert sharded (TP-in-expert)
    "experts_ep": "model",  # the expert-parallel alternative
    "inner": "model",
    "state": None,
    "conv": None,
    "lora": None,
    "unit": None,
    "layers": None,
    # caches
    "kv_seq": "model",
    "cache_batch": ("pod", "data"),
    None: None,
}

def _axis_size(mesh: dict, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    return math.prod(mesh.get(n, 1) for n in names)


def spec_for(mesh: dict, axes, shape, rules=None) -> tuple:
    """The spec of ``shape`` whose dims carry logical ``axes`` on ``mesh``
    (axis name -> size): per dimension the mesh axes of its rule that are in
    the mesh and not used by an earlier dimension, trailing axes dropped
    until they divide the dimension, None when none is left."""
    rules = rules or DEFAULT_RULES
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        target = rules.get(ax)
        if target is None:
            out.append(None)
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        names = tuple(n for n in names if n in mesh and n not in used)
        size = _axis_size(mesh, names)
        if not names or size == 1 or dim % size != 0:
            # partial fallback: drop trailing axes until divisible
            while names and (dim % _axis_size(mesh, names) != 0):
                names = names[:-1]
            if not names:
                out.append(None)
                continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    return tuple(out)


def model_dim(mesh: dict, axes, shape) -> int | None:
    """The dimension that ``spec_for`` splits over the "model" axis, or None
    when the tensor is replicated over it."""
    for d, entry in enumerate(spec_for(mesh, axes, shape)):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return d
    return None

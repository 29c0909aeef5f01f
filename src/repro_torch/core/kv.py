"""KV-cache reorganization (``repro.core.kv``): apply re-root MovePlans and
verification compaction to model caches, keeping the ``[prefix | tree]``
layout invariant.

Moves are gather-then-scatter (every source read before any write), so
overlapping src/dst rows are safe.  Row ops touch only attention-cache
leaves ("k"/"v"/"ckv"/"krope").  All row leaves of a cache are one
``kv_move_leaves`` call (``repro_torch.kernels.ops``): on the card one
kernel launch over every leaf and all U layers of each, on the CPU the
plain index-based version leaf by leaf.

In-place writes and the snapshot rule.  JAX arrays are immutable; torch
tensors are not.  The lockstep round (``EngineSession.step``) owns every
cache it touches — the reference donates all of them — so the port writes
them in place: model forwards write new K/V rows into the cache, and
``apply_moves(..., donate=True)`` moves rows in place on the card.  The
reference's snapshot rule (``repro/core/kv.py:17-27``: never mutate a cache
that a caller may still hold) binds the async round: its speculative
re-root uses ``donate=False``, which writes a fresh cache, and the fill and
regrowth that follow write only that fresh cache, so the retained
pre-reroot snapshot stays as it was until ``reconcile`` decides.

Slot lifecycle (continuous batching).  ``install_slot`` copies a solo
prefill cache into one batch row of a serving cache and ``zero_slot``
clears a retired row.  Both touch every leaf of ``groups`` and leave
``len`` alone (per-row lengths live in the tree), and both are one
``slot_write_rows`` call for the whole cache: on the card one kernel
launch, in place; on the CPU the plain version, which returns fresh
tensors.  A donor of another dtype is cast to the cache's before the
call; a leaf that breaks the kernel's contract otherwise raises; nothing
falls back leaf by leaf.
"""

from __future__ import annotations

from repro_torch.kernels import ops

ROW_KEYS = ("k", "v", "ckv", "krope")


def map_row_leaves(cache, fn):
    """Apply ``fn`` to every row-indexed cache leaf [U, B, S, ...]."""

    def rec(x):
        if isinstance(x, dict):
            return {k: (fn(v) if k in ROW_KEYS else rec(v)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rec(v) for v in x)
        return x

    return {"len": cache["len"], "groups": rec(cache["groups"])}


def apply_moves(cache, src, dst, mask, *, donate: bool = False):
    """src/dst/mask: [B, M] row move plan, applied to every row leaf in one
    ``kv_move_leaves`` call.  ``donate=True`` lets the card move rows in
    place: the caller must own the cache (see the module docstring)."""
    leaves = []
    map_row_leaves(cache, leaves.append)
    if not leaves:
        return map_row_leaves(cache, lambda arr: arr)
    moved = iter(ops.kv_move_leaves(leaves, src, dst, mask, donate=donate))
    return map_row_leaves(cache, lambda arr: next(moved))


def set_length(cache, new_len):
    return {**cache, "len": int(new_len)}


def batch_size(cache) -> int:
    """The batch rows of a cache (its first leaf's axis 1: [U, B, ...])."""
    return _flatten(cache["groups"])[0].shape[1]


def _flatten(groups) -> list:
    """The tensor leaves of a cache's ``groups`` in a fixed order."""
    if isinstance(groups, dict):
        return [x for k in sorted(groups) for x in _flatten(groups[k])]
    if isinstance(groups, (list, tuple)):
        return [x for g in groups for x in _flatten(g)]
    return [groups]


def _unflatten(groups, leaves):
    """``groups`` rebuilt with its leaves taken in order from ``leaves``."""
    if isinstance(groups, dict):
        return {k: _unflatten(groups[k], leaves) for k in sorted(groups)}
    if isinstance(groups, (list, tuple)):
        return type(groups)(_unflatten(g, leaves) for g in groups)
    return next(leaves)


def _write_slot_rows(cache, donor, slot: int):
    """Shared install/zero body: donor row 0 (zeros when ``donor`` is None)
    into batch row ``slot`` of every ``groups`` leaf, in one call.  A donor
    leaf of another dtype is cast to its cache leaf's first, as the
    reference casts it (``one[:, 0].astype(big.dtype)``)."""
    leaves = _flatten(cache["groups"])
    donor_leaves = None if donor is None else _flatten(donor["groups"])
    if donor_leaves is not None and len(donor_leaves) == len(leaves):
        donor_leaves = [one if one.dtype == big.dtype else one.to(big.dtype)
                        for big, one in zip(leaves, donor_leaves)]
    out = ops.slot_write_rows(leaves, donor_leaves, slot)
    return {"len": cache["len"], "groups": _unflatten(cache["groups"], iter(out))}


def install_slot(cache, src, slot: int):
    """Copy batch row 0 of single-request cache ``src`` into batch row
    ``slot`` of ``cache`` (in place on the card)."""
    return _write_slot_rows(cache, src, slot)


def zero_slot(cache, slot: int):
    """Zero batch row ``slot`` of every cache leaf, so a recycled slot
    starts from clean state (in place on the card)."""
    return _write_slot_rows(cache, None, slot)

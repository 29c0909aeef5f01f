"""KV-cache reorganization (``repro.core.kv``): apply re-root MovePlans and
verification compaction to model caches, keeping the ``[prefix | tree]``
layout invariant.

Moves are gather-then-scatter (every source read before any write), so
overlapping src/dst rows are safe.  Row ops touch only attention-cache
leaves ("k"/"v"/"ckv"/"krope").  Each row leaf is one ``kv_move_rows``
call (``repro_torch.kernels.ops``): on the card one kernel launch over all
U layers of the leaf, on the CPU the plain index-based version.

In-place writes and the snapshot rule.  JAX arrays are immutable; torch
tensors are not.  The lockstep round (``EngineSession.step``) owns every
cache it touches — the reference donates all of them — so the port writes
them in place: model forwards write new K/V rows into the cache, and
``apply_moves(..., donate=True)`` moves rows in place on the card.  The
reference's snapshot rule (``repro/core/kv.py:17-27``: never mutate a cache
that a caller may still hold) binds the async round, a later slice: its
speculative re-root must use ``donate=False``, which writes a fresh cache
and leaves the retained pre-reroot snapshot untouched.
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
    """src/dst/mask: [B, M] row move plan, applied to every row leaf.
    ``donate=True`` lets the card move rows in place: the caller must own
    the cache (see the module docstring)."""
    return map_row_leaves(cache, lambda arr: ops.kv_move_rows(arr, src, dst, mask, donate=donate))


def set_length(cache, new_len):
    return {**cache, "len": int(new_len)}

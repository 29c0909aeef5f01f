"""GQA attention (``repro.models.attention``): full-sequence for prefill,
cached for decode and the speculative tree.

Cached mode takes an explicit ``[B, n, S_max]`` mask — the paper's
non-square tree mask — and goes through the ``tree_attention`` kernel; a
decode step (one token at contiguous rows, no sliding window) goes through
``decode_attention`` instead, whose mask is the length.  It writes the new
K/V rows into the cache first and then attends, so every node sees its own
row.  Cache writes are in place: the lockstep round owns
every cache it touches (see ``core/kv.py``).  Prefill attention is plain
PyTorch, as the reference computes it in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope


def _project_qkv(cfg, p, x, positions, *, rope: bool = True):
    """x [B, n, d] -> q [B, n, Hq, hd], k/v [B, n, Hkv, hd] (+ QKV bias, RoPE)."""
    B, n, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).reshape(B, n, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].reshape(d, -1)).reshape(B, n, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].reshape(d, -1)).reshape(B, n, cfg.n_kv_heads, cfg.head_dim)
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, out):
    B, n, hq, hd = out.shape
    return out.reshape(B, n, hq * hd) @ p["wo"].reshape(hq * hd, -1)


def _attend(q, k, v, mask):
    """Masked softmax attention; mask [B, n, S].  Fully masked rows -> 0."""
    B, n, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, n, hkv, g, hd)
    scores = (torch.einsum("bnkgh,bskh->bkgns", qg, k) / math.sqrt(hd)).float()
    m = mask[:, None, None, :, :]
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bkgns,bskh->bnkgh", probs.to(v.dtype), v)
    return out.reshape(B, n, hq, hd)


def attention_full(cfg, p, x, positions):
    """Causal full-sequence attention (prefill).  Returns (out [B, S, d],
    (k, v)) — the computed K/V for cache population."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    m = positions[:, None, :] <= positions[:, :, None]  # [B, S_q, S_k]
    if cfg.sliding_window:
        m &= positions[:, None, :] > (positions[:, :, None] - cfg.sliding_window)
    return _out_proj(p, _attend(q, k, v, m)), (k, v)


def update_rows_contiguous(cache, rows, start: int):
    """Write ``rows [B, n, ...]`` into ``cache [B, S, ...]`` at rows
    [start, start+n), in place; rows past S are dropped."""
    n = min(rows.shape[1], max(cache.shape[1] - start, 0))
    cache[:, start:start + n] = rows[:, :n].to(cache.dtype)
    return cache


def plan_row_writes(row_idx, S: int, row_mask=None):
    """The index side of ``scatter_rows`` for ``row_idx [B, n]`` into S
    cache rows: one plan serves every cache that a forward writes at these
    rows (k and v of every attention layer).  An entry is kept when its
    row lies in [0, S) (and row_mask is set).  Dropped entries write no
    row of their own: each rewrites the batch row's highest kept row with
    that row's final value, or, when a batch row keeps nothing, row 0 with
    row 0's current value — no host sync, and never counted as a writer.

    Returns (idx [B, n, 1] int64: the row each entry writes; same [B, n, n]
    bool: entry j is kept and writes entry i's row; first [B, n, 1] int64:
    the first such j; dup [B, n, 1] bool: more than one; keep [B, 1, 1]
    bool: the batch row keeps an entry)."""
    valid = (row_idx >= 0) & (row_idx < S)
    if row_mask is not None:
        valid = valid & row_mask
    key = torch.where(valid, row_idx, -1)  # the row a kept entry writes, -1 if dropped
    top = key.amax(1, keepdim=True)  # [B, 1]: the highest kept row, -1 if none
    idx = torch.where(valid, row_idx, top.clamp_min(0)).long()
    same = idx[:, :, None] == key[:, None, :]
    return (idx[:, :, None], same, same.int().argmax(2, keepdim=True),
            same.sum(2, keepdim=True) > 1, (top >= 0)[:, :, None])


def scatter_rows(cache, rows, row_idx, row_mask=None, *, plan=None):
    """Write ``rows [B, n, ...]`` into ``cache [B, S, ...]`` at ``row_idx
    [B, n]``, in place, as the reference's one-hot write does: a row that
    one kept entry writes takes that entry's value bit for bit, a row that
    several write takes their sum (in entry order, so every writer of the
    row writes the same bytes).  Entries with row_idx outside [0, S) (or
    row_mask False) are dropped.  ``plan``: ``plan_row_writes(row_idx, S,
    row_mask)``, computed here when None."""
    B, S = cache.shape[:2]
    n = rows.shape[1]
    idx, same, first, dup, keep = plan if plan is not None else \
        plan_row_writes(row_idx, S, row_mask)
    flat_c = cache.view(B, S, -1)
    flat_r = rows.reshape(B, n, -1).to(cache.dtype)
    F = flat_c.shape[-1]
    # -0.0 is the additive identity that leaves every value as it was
    sums = torch.where(same[..., None], flat_r[:, None], -0.0).sum(2)
    val = torch.where(dup, sums, flat_r.gather(1, first.expand(B, n, F)))
    val = torch.where(keep, val, flat_c[:, :1])
    flat_c.scatter_(1, idx.expand(B, n, F), val)
    return cache


def attention_cached(cfg, p, x, cache_k, cache_v, row_idx, positions, attn_mask, *,
                     row_start=None, row_plan=None):
    """Cached attention for decode / spec-tree forward.

    x: [B, n, d] new tokens; their K/V are written at ``row_idx`` [B, n]
    (absolute cache rows, -1 = skip), or at [row_start, row_start+n) for
    every batch row when ``row_start`` is given (decode/chain).  Then the n
    queries attend the whole cache under ``attn_mask`` [B, n, S_max].  At
    n = 1 with ``row_start`` and no sliding window that mask is cols <=
    row_start, so ``decode_attention`` computes it from the length
    row_start + 1; its K/V write is enqueued on the same stream first.
    ``row_plan``: ``plan_row_writes(row_idx, S)``, shared by the layers.
    With ``row_start`` no query attends a row at or past row_start + n,
    so tree_attention gets that host-int bound (it launches only the
    splits below it).  Returns (out, cache_k, cache_v)."""
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    if row_start is not None:
        update_rows_contiguous(cache_k, k_new, row_start)
        update_rows_contiguous(cache_v, v_new, row_start)
    else:
        row_plan = row_plan or plan_row_writes(row_idx, cache_k.shape[1])
        scatter_rows(cache_k, k_new, row_idx, plan=row_plan)
        scatter_rows(cache_v, v_new, row_idx, plan=row_plan)
    if row_start is not None and x.shape[1] == 1 and not cfg.sliding_window:
        out = ops.decode_attention(q[:, 0], cache_k, cache_v, int(row_start) + 1)[:, None]
    else:
        bound = None if row_start is None else int(row_start) + x.shape[1]
        out = ops.tree_attention(q, cache_k, cache_v, attn_mask, kv_bound=bound)
    return _out_proj(p, out), cache_k, cache_v

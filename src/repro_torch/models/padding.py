"""Arbitrary-TP zero padding (``repro.models.padding``; paper §4).

``configs.resolve_for_tp`` widens head counts and ff widths so that every
product splits over the tensor-parallel degree; ``pad_params`` embeds a
model's weights into the widened shapes with zeros, tensor by tensor
(``pad_tensor``, which a tensor-parallel rank also applies to each tensor
it draws, before it keeps its shard).

Zero padding computes the same function: a padded ff column gives
silu(0)·0 = 0 through a zero row of the down projection (rwkv6's
channel-mix: relu(0)² = 0 through a zero row of ``cm_v``), and a padded
attention head reaches the output only through its zero rows of ``wo``.
``resolve_for_tp`` changes no dimension of the mamba2 and rwkv6 time-mix
tensors, so they keep their shapes; zamba2's shared block pads as a dense
block does.

GQA: query heads are grouped per KV head (g = Hq/Hkv), so a widened group
takes its new heads at its end — old head k·g + j lands at k·g' + j — or
the grouping reshape would pair queries with the wrong KV heads.
"""

from __future__ import annotations

import torch

from repro_torch.models.axes import weight_axes
from repro_torch.models.transformer import DecoderLM, map_params


def head_map(hq_old: int, hq_new: int, hkv_old: int, hkv_new: int) -> torch.Tensor:
    """Old query-head index -> new index, preserving the KV grouping: old
    head k·g_old + j lands at k·g_new + j (the identity when the KV heads
    widened at a fixed g, or without a grouping)."""
    if hkv_old <= 0 or hq_old % hkv_old or hkv_new <= 0 or hq_new % hkv_new:
        return torch.arange(hq_old)
    g_old, g_new = hq_old // hkv_old, hq_new // hkv_new
    k = torch.arange(hq_old) // g_old
    j = torch.arange(hq_old) % g_old
    return k * g_new + j


def _ff(cfg, where: str) -> int:
    dff = cfg.moe_d_ff or cfg.d_ff
    return {"mlp": cfg.d_ff, "moe": dff, "shared": cfg.n_shared_experts * dff,
            "tm": cfg.d_ff}[where]


def _padded_size(small, big, where: str, ax, size: int) -> int:
    if ax == "heads" and size == small.n_heads:
        return big.n_heads
    if ax == "kv_heads" and size == small.n_kv_heads:
        return big.n_kv_heads
    if ax == "ff" and where in ("mlp", "moe", "shared", "tm") and size == _ff(small, where):
        return _ff(big, where)
    return size


def pad_tensor(cfg_small, cfg_big, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` of the model of ``cfg_small`` (``param_where``'s where and key)
    as the model of ``cfg_big = resolve_for_tp(cfg_small, tp)`` holds it:
    zeros past every old extent, and the query heads of a widened group
    placed by ``head_map``.  A tensor that keeps its shape is returned as
    it is."""
    axes = weight_axes(where, key)
    if axes is None or cfg_small == cfg_big:
        return t
    shape = tuple(_padded_size(cfg_small, cfg_big, where, ax, n) for ax, n in zip(axes, t.shape))
    if shape == tuple(t.shape):
        return t
    out = t.new_zeros(shape)
    heads = [d for d, ax in enumerate(axes)
             if ax == "heads" and t.shape[d] == cfg_small.n_heads and shape[d] == cfg_big.n_heads]
    if not heads:
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out
    (d,) = heads  # one heads dim per tensor in this zoo
    hmap = head_map(cfg_small.n_heads, cfg_big.n_heads, cfg_small.n_kv_heads,
                    cfg_big.n_kv_heads).to(t.device)
    moved, tgt = t.movedim(d, 0), out.movedim(d, 0)
    tgt[(hmap,) + tuple(slice(0, n) for n in moved.shape[1:])] = moved
    return out


def pad_params(cfg_small, cfg_big, params: DecoderLM) -> DecoderLM:
    """The zero-padded ``DecoderLM`` of ``cfg_big`` holding ``params`` (a
    model of ``cfg_small``).  The reference takes an init of the big config
    for the shapes; here they follow from the configs."""
    return map_params(params, lambda where, key, t: pad_tensor(cfg_small, cfg_big, where, key, t))


def unpad_tensor(cfg_small, cfg_big, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pad_tensor``: ``t`` of the padded model as the
    unpadded model holds it (a view where no head moved)."""
    axes = weight_axes(where, key)
    if axes is None or cfg_small == cfg_big:
        return t
    for d, ax in enumerate(axes):
        if ax == "heads" and t.shape[d] == cfg_big.n_heads and cfg_big.n_heads != cfg_small.n_heads:
            hmap = head_map(cfg_small.n_heads, cfg_big.n_heads, cfg_small.n_kv_heads,
                            cfg_big.n_kv_heads).to(t.device)
            t = t.index_select(d, hmap)
    for d, ax in enumerate(axes):
        small = _padded_size(cfg_big, cfg_small, where, ax, t.shape[d])  # big -> small
        if small != t.shape[d]:
            t = t.narrow(d, 0, small)
    return t

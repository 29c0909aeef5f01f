"""Tensor-parallel shards of the port's weights.

``Shard(cfg, rank, world)`` is one rank's view of a model of ``cfg``
sharded over ``world`` ranks: the config padded by
``configs.resolve_for_tp``, the per-rank config its forward runs at
(``local_cfg``), and ``tensor(where, key, t)``, which pads one tensor of the
unpadded model (``models.padding.pad_tensor``) and keeps this rank's part
of it as a contiguous tensor of its own (16-byte aligned, so that the
kernels take it as it is and nothing keeps the whole tensor alive).

What a rank keeps, by ``rules.spec_for`` over the mesh {"model": world}:

* ``wg``/``wu`` split by ff columns and ``wd`` by its rows (the dense MLP
  and, in the "tp" MoE form, every expert's ff); the "ep" form splits the
  routed experts instead.  A rank's share of the dense MLP is zero-padded
  to a multiple of ``FF_ALIGN`` (zero columns of wg/wu, zero rows of wd:
  exact, as ``resolve_for_tp``'s own padding is), so that ``fused_swiglu``
  streams its rows in 16-byte copies (at an odd width a bf16 row goes by
  byte loads, ROADMAP R7).  The router, the norms and a MoE block's shared
  experts are whole on every rank.
* ``embed`` and ``lm_head`` split by vocabulary where the ranks divide it
  (a masked lookup and an all-reduce, the logits gathered), else whole.
* Attention by heads, in the layout of ``attn_layout``: where the ranks
  divide the KV heads, each rank its contiguous query heads and their KV
  heads (spec_for's split).  Where they do not, the reference replicates
  wk/wv; here a rank keeps only the KV heads its query heads read, and pads
  its query heads to whole groups with zero heads (zero ``wq`` columns and
  ``wo`` rows), so that every rank runs the kernels' uniform grouping G =
  Hq/Hkv, and its cache holds those KV heads only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import resolve_for_tp
from repro_torch.models.axes import weight_axes
from repro_torch.models.padding import pad_tensor
from repro_torch.models.transformer import (
    DecoderLM,
    check_plan,
    map_named_params,
    map_params,
    param_where,
)
from repro_torch.parallel.rules import model_dim

_Q_KEYS = ("wq", "bq", "wo")
_KV_KEYS = ("wk", "wv", "bk", "bv")
TP_KINDS = ("dense", "moe")  # the blocks a group of several ranks runs (ROADMAP 13d: the rest)
FF_ALIGN = 8  # a rank's dense-MLP width is a multiple of this: 16-byte rows in bf16
_MLP_KEYS = ("wg", "wu", "wd")


def attn_layout(n_heads: int, n_kv_heads: int, rank: int, world: int) -> tuple[tuple, tuple]:
    """(q_src, kv_src) of rank ``rank``: the global query head of each local
    query slot (-1 for a zero head) and the global KV head of each local KV
    slot.  The rank owns query heads [rank·Hq/world, (rank+1)·Hq/world); it
    keeps every KV head they read and, for each, the g = Hq/Hkv slots of its
    group, holding the owned heads at their place in the group and zero
    heads elsewhere.  Where world divides Hkv the groups are whole and this
    is the contiguous split."""
    if world == 1:
        return tuple(range(n_heads)), tuple(range(n_kv_heads))
    if n_heads % world:
        raise ValueError(f"{n_heads} query heads do not split over {world} ranks "
                         "(configs.resolve_for_tp pads them)")
    g, per = n_heads // n_kv_heads, n_heads // world
    own = range(rank * per, (rank + 1) * per)
    kv_src = tuple(sorted({q // g for q in own}))
    q_src = tuple(k * g + j if k * g + j in own else -1 for k in kv_src for j in range(g))
    return q_src, kv_src


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world`` of a model of ``cfg`` (unpadded);
    ``moe_form`` "tp" or "ep" (taken only where world divides E)."""

    cfg: Any
    rank: int
    world: int
    moe_form: str = "tp"

    def __post_init__(self):
        if self.moe_form not in ("tp", "ep"):
            raise ValueError(f"moe_form must be 'tp' or 'ep', got {self.moe_form!r}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a group of {self.world}")

    @functools.cached_property
    def padded(self):
        return resolve_for_tp(self.cfg, self.world)

    @property
    def ep(self) -> bool:
        E = self.cfg.n_experts
        return self.moe_form == "ep" and E > 0 and E % self.world == 0

    @functools.cached_property
    def attn(self) -> tuple[tuple, tuple]:
        c = self.padded
        return attn_layout(c.n_heads, c.n_kv_heads, self.rank, self.world)

    @functools.cached_property
    def ff(self) -> int:
        """This rank's dense-MLP width: its share of the padded d_ff, rounded
        up to a multiple of ``FF_ALIGN`` when the ranks split it."""
        share = self.padded.d_ff // self.world
        return share if self.world == 1 else -(-share // FF_ALIGN) * FF_ALIGN

    @functools.cached_property
    def vocab_split(self) -> bool:
        """Whether embed and lm_head are split by vocabulary (where the ranks
        divide it; else whole on every rank)."""
        c = self.padded
        return self.world > 1 and model_dim({"model": self.world}, weight_axes("model", "lm_head"),
                                            (c.d_model, c.vocab_size)) is not None

    @functools.cached_property
    def local_cfg(self):
        """The padded config at this rank's shapes, which its forward and its
        cache run at: its head counts, its dense-MLP width ``ff``, its
        experts' width (the "tp" MoE form's share; the "ep" form keeps
        whole experts, E/world of them, and ``n_experts`` stays E: the
        capacity is the whole dispatch's) and its vocabulary."""
        c = self.padded
        kw = dict(d_ff=self.ff, vocab_size=c.vocab_size // self.world if self.vocab_split
                  else c.vocab_size)
        if c.n_experts:
            dff = c.moe_d_ff or c.d_ff
            kw["moe_d_ff"] = dff if self.ep else dff // self.world
        if c.n_heads:
            q_src, kv_src = self.attn
            kw.update(n_heads=len(q_src), n_kv_heads=len(kv_src), head_dim=c.head_dim)
        return dataclasses.replace(c, **kw)

    def check(self) -> None:
        """Raise for a model a group of several ranks does not run yet."""
        kinds = {kind for unit, _ in check_plan(self.cfg) for kind in unit}
        if self.world > 1 and (self.cfg.attn_kind != "gqa" or not kinds <= set(TP_KINDS)):
            raise NotImplementedError(
                f"{self.cfg.name}: tensor parallelism over {self.world} ranks runs the dense "
                f"GQA and MoE blocks; {sorted(kinds - set(TP_KINDS)) or [self.cfg.attn_kind]} "
                "come with ROADMAP item 13d")

    def tensor(self, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, a tensor of the unpadded model."""
        return self.slice(where, key, pad_tensor(self.cfg, self.padded, where, key, t))

    def slice(self, where: str, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``, a tensor of the padded model."""
        fresh = dict(memory_format=torch.contiguous_format)
        if self.world == 1 or where in ("block", "shared") or (where, key) == ("moe", "router"):
            return t.clone(**fresh)
        if where == "attn" and key in _Q_KEYS + _KV_KEYS:
            src = self.attn[0] if key in _Q_KEYS else self.attn[1]
            dim = 1 if key in ("wq", "wk", "wv") else 0
            out = t.index_select(dim, torch.tensor([max(s, 0) for s in src], device=t.device))
            for slot, s in enumerate(src):
                if s < 0:
                    out.select(dim, slot).zero_()
            return out
        axes = weight_axes(where, key, "ep" if self.ep else "tp")
        if axes is None:
            raise NotImplementedError(f"no tensor-parallel split of {where}.{key} (ROADMAP 13d)")
        d = model_dim({"model": self.world}, axes, t.shape)
        if d is None:
            return t.clone(**fresh)
        n = t.shape[d] // self.world
        part = t.narrow(d, self.rank * n, n)
        if where == "mlp" and key in _MLP_KEYS and self.ff != n:
            out = t.new_zeros(part.shape[:d] + (self.ff,) + part.shape[d + 1:])
            out.narrow(d, 0, n).copy_(part)
            return out
        return part.clone(**fresh)

    def params(self, params: DecoderLM) -> DecoderLM:
        """This rank's ``DecoderLM`` of a whole, unpadded one."""
        return map_params(params, self.tensor)

    def join(self, where: str, key: str, pieces: list) -> torch.Tensor:
        """The padded model's tensor from every rank's part (``slice``'s
        inverse; ``pieces`` in rank order, each rank's ``Shard`` of the same
        cfg and world)."""
        if self.world == 1 or where in ("block", "shared") or (where, key) == ("moe", "router"):
            return pieces[0]
        if where == "attn" and key in _Q_KEYS + _KV_KEYS:
            c, q = self.padded, key in _Q_KEYS
            dim = 1 if key in ("wq", "wk", "wv") else 0
            shape = list(pieces[0].shape)
            shape[dim] = c.n_heads if q else c.n_kv_heads
            out = pieces[0].new_zeros(shape)
            for rank, piece in enumerate(pieces):
                src = attn_layout(c.n_heads, c.n_kv_heads, rank, self.world)[0 if q else 1]
                for slot, s in enumerate(src):
                    if s >= 0:
                        out.select(dim, s).copy_(piece.select(dim, slot))
            return out
        c = self.padded
        dff = c.moe_d_ff or c.d_ff
        full = {("mlp", "wg"): (c.d_model, c.d_ff), ("mlp", "wu"): (c.d_model, c.d_ff),
                ("mlp", "wd"): (c.d_ff, c.d_model), ("moe", "wg"): (c.n_experts, c.d_model, dff),
                ("moe", "wu"): (c.n_experts, c.d_model, dff),
                ("moe", "wd"): (c.n_experts, dff, c.d_model),
                ("model", "embed"): (c.vocab_size, c.d_model),
                ("model", "lm_head"): (c.d_model, c.vocab_size)}.get((where, key))
        axes = weight_axes(where, key, "ep" if self.ep else "tp")
        d = None if full is None else model_dim({"model": self.world}, axes, full)
        if d is None:
            return pieces[0]
        if where == "mlp" and key in _MLP_KEYS:  # each rank's share without its padding
            pieces = [t.narrow(d, 0, full[d] // self.world) for t in pieces]
        return torch.cat(pieces, d)


def unshard_params(cfg, shards: list, moe_form: str = "tp") -> DecoderLM:
    """The whole, unpadded ``DecoderLM`` of ``cfg`` from every rank's
    shards (``shards[r]``: rank r's ``DecoderLM`` of a group of
    ``len(shards)``)."""
    from repro_torch.models.padding import unpad_tensor

    shard = Shard(cfg, 0, len(shards), moe_form)
    by_rank = [dict(s.named_parameters()) for s in shards]

    def whole(name, t):
        where, key = param_where(name)
        joined = shard.join(where, key, [p[name].detach() for p in by_rank])
        return unpad_tensor(cfg, shard.padded, where, key, joined).clone(
            memory_format=torch.contiguous_format)

    return map_named_params(shards[0], whole)


def shard_params(cfg, params: DecoderLM, group, moe_form: str = "tp") -> DecoderLM:
    """``params`` (a whole model of ``cfg``) as rank ``group.rank`` of
    ``group.world`` keeps it: padded by ``resolve_for_tp`` and sliced, tensor
    by tensor."""
    return Shard(cfg, group.rank, group.world, moe_form).params(params)
